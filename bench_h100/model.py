"""The benchmark's weights, made on the device from the seed, and the
program's net built around copies of them.

A configuration file gives `input_dim`, `lstmp_layers` (each
`cell_dim`, `proj_dim`, `param_scale`), `num_pdfs` and the senone
layer's `affine_stddev`, `affine_bias_mean` and `affine_bias_range`,
as the published `nnet.proto` does: uniform [-scale, scale] LSTMP
weights (the reference's InitData), Gaussian affine weights. Training
starts from that initialisation. Scoring scores a trained model, whose
LSTMP weights are drawn at `trained_param_scale` instead: at the
initial 0.01 the logits' RMS is about 4e-4, so the float32 rounding
of the prior-subtracted scores (about 1e-6 at |score| near 10) would
hide a lower precision's error.
"""

from __future__ import annotations

import torch

from bench_h100.reference.lstmp import LEAF_NAMES
from bench_h100.yardstick import layer_dims


def make_weights(config: dict, seed: int, device,
                 trained: bool = False) -> dict:
    """The weights in the reference's layout, in three draws on
    `device`: every LSTMP leaf, the affine matrix, the affine bias;
    `trained` draws the LSTMP leaves at `trained_param_scale`."""
    g = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    dims = layer_dims(config)
    shapes = [[(4 * C, I), (4 * C, R), (4 * C,), (C,), (C,), (C,), (R, C)]
              for I, C, R in dims]
    total = sum(torch.Size(s).numel() for layer in shapes for s in layer)
    u = torch.rand(total, generator=g, device=device)
    layers, at = [], 0
    for spec, layer in zip(config["lstmp_layers"], shapes):
        scale = float(config["trained_param_scale"] if trained
                      else spec["param_scale"])
        leaves = {}
        for name, s in zip(LEAF_NAMES, layer):
            n = torch.Size(s).numel()
            leaves[name] = (u[at:at + n] * (2 * scale) - scale).reshape(s)
            at += n
        layers.append(leaves)
    K, R = config["num_pdfs"], dims[-1][2]
    w = torch.randn(K * R, generator=g, device=device).reshape(K, R) \
        * float(config["affine_stddev"])
    b = float(config["affine_bias_mean"]) + (
        torch.rand(K, generator=g, device=device) - 0.5) \
        * float(config["affine_bias_range"])
    return {"lstmp": layers, "affine": {"linearity": w, "bias": b}}


def program_net(config: dict, weights: dict, nstream: int):
    """(Nnet, params) of the program: Transmit, the LSTMP layers
    (LstmProjectedStreams), AffineTransform, Softmax, over copies of
    `weights` (the program updates its params in place)."""
    from kaldi_lstm_tpu_torch.models import components as comp
    from kaldi_lstm_tpu_torch.models.nnet import Nnet
    from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmParams

    I0 = config["input_dim"]
    comps, params = [comp.Transmit(I0, I0)], [{}]
    for spec, (I, C, R), leaves in zip(config["lstmp_layers"],
                                      layer_dims(config), weights["lstmp"]):
        comps.append(comp.LstmProjectedStreams(
            I, R, cell_dim=C, nstream=nstream,
            param_scale=float(spec["param_scale"])))
        params.append(LstmParams(**{k: t.clone() for k, t in leaves.items()}))
    K, R = config["num_pdfs"], layer_dims(config)[-1][2]
    comps += [comp.AffineTransform(R, K), comp.Softmax(K, K)]
    params += [{k: t.clone() for k, t in weights["affine"].items()}, {}]
    return Nnet(comps), tuple(params)


def program_leaves(params) -> list:
    """The program's weight tensors in the reference's leaf order
    (`reference.lstmp.leaves`)."""
    out = []
    for p in params[1:-2]:
        out += [getattr(p, k) for k in LEAF_NAMES]
    return out + [params[-2]["linearity"], params[-2]["bias"]]
