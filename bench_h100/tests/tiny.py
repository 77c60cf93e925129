"""A cell of each kind cut to a CPU test's size: the real cell's entry
with a tiny configuration, traffic and check."""

from bench_h100 import catalog

CONFIG = {"input_dim": 6, "num_pdfs": 30, "trained_param_scale": 0.3,
          "affine_stddev": 0.3, "affine_bias_mean": 0.0,
          "affine_bias_range": 0.0,
          "lstmp_layers": [{"cell_dim": 12, "proj_dim": 8,
                            "param_scale": 0.1}]}
UTTS = {"median_frames": 20, "sigma": 0.5, "min_frames": 6,
        "max_frames": 50, "run_min": 3, "run_max": 12}
TRAIN = dict(UTTS, kind="train", pool=40, streams=4, tbptt=5,
             targets_delay=2, step_group=2, learn_rate=1e-2, momentum=0.9)
SCORE = dict(UTTS, kind="score", pool=24, batch_utts=3, length_bucket=8,
             pipeline=True)
# float32 against float32 on the CPU: the plain versions and the
# reference sum in the same orders, so gaps are rounding-sized
TRAIN_CHECK = {"epochs": [1, 2, 4], "change_at": 3,
               "limits": {"loss_gap": 1e-5, "grad_gap": 1e-4,
                          "change_gap": 1e-4, "change_gap.setup": 1e-4,
                          "frames_gap": 0}}
SCORE_CHECK = {"sample": 4, "sample_span": 30,
               "limits": {"score_gap": 1e-4, "missing": 0}}


def cell(kind: str, layers: int = 1, root: str = catalog.ROOT):
    name = {"train": "train-google-f32", "score": "score-deep-f32"}[kind]
    cfg = dict(CONFIG, lstmp_layers=CONFIG["lstmp_layers"] * layers)
    return catalog.cell(name, root)._replace(
        config=cfg, traffic=TRAIN if kind == "train" else SCORE,
        check=TRAIN_CHECK if kind == "train" else SCORE_CHECK)
