"""The port's posterior and count tools (`ali_to_post`,
`compute_class_counts`, `analyze_counts`, `post_to_weights`,
`scale_post`, `sum_post`, `weight_silence_post`, `copy_int_vector`)
against the JAX package's: on tables made with numpy from a seed, each
tool and its JAX twin exit with the same code, write the same bytes
(binary and text tables, `ark:` and `scp:` inputs) and log the same
lines (the timestamps aside).
"""

import importlib
import re

import numpy as np
import pytest

from kaldi_lstm_tpu.io import transition_model as jtm
from kaldi_lstm_tpu_torch.io import kaldi_io as kio

_STAMP = re.compile(r"\(\d\d:\d\d:\d\d\)")


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """Alignments (transition-ids and pdfs), multi-entry posteriors (an
    ark with its scp index, a second table with one short utterance and
    one missing), scalar and per-frame scale tables, a transition
    model."""
    d = str(tmp_path_factory.mktemp("tables"))
    tm = jtm.make_monophone_transition_model(4, 2)
    tm.dump(f"{d}/final.mdl")
    ntid = len(tm.id2pdf)
    rng = np.random.RandomState(0)
    lens = {f"utt{i}": int(rng.randint(3, 12)) for i in range(5)}
    with kio.TableWriter(f"ark:{d}/ali.ark", kio.write_int_vector) as w, \
            kio.TableWriter(f"ark:{d}/pdf.ark", kio.write_int_vector) as wp:
        for k, n in lens.items():
            tids = rng.randint(1, ntid, n).astype(np.int32)
            w.write(k, tids)
            wp.write(k, tm.transition_ids_to_pdfs(tids).astype(np.int32))

    def post(n, ids):
        return [[(int(rng.randint(1, ids)), float(rng.rand()))
                 for _ in range(int(rng.randint(1, 4)))] for _ in range(n)]
    with kio.PosteriorWriter(f"ark,scp:{d}/post.ark,{d}/post.scp") as w, \
            kio.PosteriorWriter(f"ark:{d}/post2.ark") as w2:
        for i, (k, n) in enumerate(lens.items()):
            p = post(n, ntid)
            p[0] = [(1, 0.5), (1, 0.25), (2, 0.0)]     # duplicates, a zero
            w.write(k, p)
            if i == 1:
                w2.write(k, post(n - 1, ntid))           # one frame short
            elif i != 2:                                  # utt2 missing
                w2.write(k, [[(a, 1.0) for a, _ in p[0]]]
                         + post(n - 1, ntid))
    with kio.TableWriter(f"ark:{d}/scales.ark", kio.write_float) as w:
        for k in list(lens)[:-1]:                        # last one missing
            w.write(k, float(rng.rand()))
    with kio.TableWriter(f"ark:{d}/frame_scales.ark", kio.write_vector) as w:
        for k, n in lens.items():
            w.write(k, rng.rand(n if k != "utt3" else n + 1)
                    .astype(np.float32))
    return d


def run_pair(capfd, tmp_path, tool, argv):
    """Runs the JAX tool and the port's on argv, where "{out}" stands for
    each one's own output file; asserts both give the same (exit code,
output bytes, log without timestamps) and returns the port's."""
    out = []
    for pkg in ("kaldi_lstm_tpu", "kaldi_lstm_tpu_torch"):
        path = tmp_path / f"{pkg}.out"
        main = importlib.import_module(f"{pkg}.tools.{tool}").main
        rc = main([a.replace("{out}", str(path)) for a in argv])
        err = _STAMP.sub("", capfd.readouterr().err).replace(str(path), "")
        out.append((rc, path.read_bytes() if path.exists() else None, err))
    assert out[1] == out[0]
    return out[1]


@pytest.mark.parametrize("spec", ["ark:{out}", "ark,t:{out}"])
def test_ali_to_post(capfd, tmp_path, tables, spec):
    rc, data, _ = run_pair(capfd, tmp_path, "ali_to_post",
                           [f"ark:{tables}/pdf.ark", spec])
    assert rc == 0 and data


@pytest.mark.parametrize("extra", [[], ["--binary", "true"],
                                   ["--counts-offset", "0.5"]])
@pytest.mark.parametrize("src", ["ark:{d}/post.ark", "scp:{d}/post.scp"])
def test_compute_class_counts(capfd, tmp_path, tables, src, extra):
    rc, data, _ = run_pair(capfd, tmp_path, "compute_class_counts",
                           [src.format(d=tables), "{out}",
                            "--num-classes", "20"] + extra)
    assert rc == 0 and data


@pytest.mark.parametrize("extra", [[], ["--num-classes", "8"],
                                   ["--num-classes", "12", "--binary",
                                    "true", "--counts-padding", "1"],
                                   ["--num-classes", "3"]])
def test_analyze_counts(capfd, tmp_path, tables, extra):
    rc, data, _ = run_pair(capfd, tmp_path, "analyze_counts",
                           [f"ark:{tables}/pdf.ark", "{out}"] + extra)
    assert rc == (1 if extra == ["--num-classes", "3"] else 0)


def test_post_to_weights(capfd, tmp_path, tables):
    rc, data, _ = run_pair(capfd, tmp_path, "post_to_weights",
                           [f"ark:{tables}/post.ark", "ark:{out}"])
    assert rc == 0 and data


@pytest.mark.parametrize("scale", ["0.25", "ark:{d}/scales.ark",
                                   "ark:{d}/frame_scales.ark"])
def test_scale_post(capfd, tmp_path, tables, scale):
    rc, data, err = run_pair(capfd, tmp_path, "scale_post",
                             [f"ark:{tables}/post.ark",
                              scale.format(d=tables), "ark,t:{out}"])
    assert rc == 0 and data
    if scale != "0.25":
        assert "1 errors" in err


@pytest.mark.parametrize("extra", [[], ["--merge", "false"],
                                   ["--scale1", "0.5", "--scale2", "2"],
                                   ["--zero-if-disjoint", "true"]])
@pytest.mark.parametrize("second", ["ark:{d}/post2.ark", "scp:{d}/post.scp"])
def test_sum_post(capfd, tmp_path, tables, second, extra):
    rc, data, err = run_pair(capfd, tmp_path, "sum_post",
                             [f"ark:{tables}/post.ark",
                              second.format(d=tables), "ark:{out}"] + extra)
    assert rc == 0 and data
    assert ("2 errors" in err) == second.endswith("post2.ark")


@pytest.mark.parametrize("distribute", ["false", "true"])
@pytest.mark.parametrize("weight", ["0.0", "0.3"])
def test_weight_silence_post(capfd, tmp_path, tables, weight, distribute):
    rc, data, _ = run_pair(capfd, tmp_path, "weight_silence_post",
                           [weight, "1:3", f"{tables}/final.mdl",
                            f"ark:{tables}/post.ark", "ark:{out}",
                            "--distribute", distribute])
    assert rc == 0 and data


@pytest.mark.parametrize("argv", [["ark:{d}/ali.ark", "ark:{out}"],
                                  ["ark:{d}/ali.ark", "ark:{out}",
                                   "--binary", "false"],
                                  ["ark:{d}/ali.ark", "ark,t:{out}"],
                                  ["scp:{d}/post.scp", "ark:{out}"]])
def test_copy_int_vector(capfd, tmp_path, tables, argv):
    rc, data, _ = run_pair(capfd, tmp_path, "copy_int_vector",
                           [a.format(d=tables) if "{d}" in a else a
                            for a in argv])
    assert rc == (1 if argv[0].startswith("scp") else 0)
