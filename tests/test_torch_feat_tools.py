"""The port's 18 front-end and feature-table tools against the JAX
package's: on wav and feature tables made with numpy from a seed, each
tool and its JAX twin exit with the same code, write the same files
byte for byte (binary and text tables, `ark:` and `scp:` inputs,
`--compress true`), print the same standard output and log the same
lines (the timestamps aside). The error paths are among the cases: a
missing utterance (no CMVN stats, no second stream, no recording), a
length mismatch in `paste_feats`, empty input to
`compute_cmvn_transform` and the refusals of each tool (rc 1).
"""

import importlib
import os
import re

import numpy as np
import pytest
import torch

from kaldi_lstm_tpu.io import transition_model as jtm
from kaldi_lstm_tpu_torch.io import kaldi_io as kio
from kaldi_lstm_tpu_torch.io.wav import WaveWriter, write_wav

_STAMP = re.compile(r"\(\d\d:\d\d:\d\d\)")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A wav.scp (mono 16 kHz, one stereo, one at 8 kHz, one too short),
    the same recordings as a wav-ark with its scp, feature tables (an
    ark with its scp, a text ark, a 13-dim second stream with one short
    and one missing utterance), CMVN maps, a segments file, a transition
    model with its alignments, and an empty table."""
    d = str(tmp_path_factory.mktemp("feat_tools"))
    rng = np.random.RandomState(0)
    recs = {"a1": (16000, rng.randn(1, 5000) * 3000),
            "a2": (16000, rng.randn(2, 4100) * 2000),
            "a3": (8000, rng.randn(1, 3000) * 1000),
            "a4": (16000, rng.randn(1, 300) * 1000),
            "a5": (16000, rng.randn(1, 6000) * 500)}
    with open(f"{d}/wav.scp", "w") as f, \
            WaveWriter(f"ark,scp:{d}/wav.ark,{d}/wavark.scp") as w:
        for k, (fs, x) in recs.items():
            write_wav(f"{d}/{k}.wav", fs, x)
            f.write(f"{k} {d}/{k}.wav\n")
            w.write(k, fs, x)
    with open(f"{d}/wav16.scp", "w") as f:
        f.write("".join(f"{k} {d}/{k}.wav\n" for k in ("a1", "a2", "a5")))
    lens = {f"utt{i}": int(rng.randint(5, 30)) for i in range(6)}
    feats = {k: (rng.randn(n, 6) * 2 + 1).astype(np.float32)
             for k, n in lens.items()}
    with kio.MatrixWriter(f"ark,scp:{d}/feats.ark,{d}/feats.scp") as w, \
            kio.MatrixWriter(f"ark,t:{d}/feats.txt") as wt, \
            kio.MatrixWriter(f"ark:{d}/second.ark") as w2:
        for i, (k, m) in enumerate(feats.items()):
            w.write(k, m)
            wt.write(k, m)
            if i != 2:                           # utt2 has no second stream
                n = len(m) - (3 if i == 4 else 1 if i == 1 else 0)
                w2.write(k, rng.randn(n, 13).astype(np.float32))
    open(f"{d}/empty.ark", "wb").close()
    with open(f"{d}/spk2utt", "w") as f:
        f.write("s1 utt0 utt1 utt4\ns2 utt2 utt3\ns3 nobody\n")
    with open(f"{d}/utt2spk", "w") as f:
        f.write("utt0 s1\nutt1 s1\nutt2 s2\nutt3 s2\nutt4 s1\nutt5 s9\n")
    with open(f"{d}/keys", "w") as f:
        f.write("utt1\nutt3 extra\n\nutt5\n")
    with open(f"{d}/segments", "w") as f:
        f.write("seg1 a1 0.0 0.2\nseg2 a1 0.1 0.0\nseg3 a2 0.05 0.2 1\n"
                "seg4 a2 0.0 0.1\nseg5 a2 0.0 0.1 3\nseg6 a1 0.1 0.35\n"
                "seg7 a1 0.1 1.5\nseg8 a3 0.1 0.15\nseg9 zz 0.0 1.0\n"
                "seg10 a5 0.0 0.0\n")
    with open(f"{d}/bad_segments", "w") as f:
        f.write("seg1 a1 0.5 0.2\n")
    tm = jtm.make_monophone_transition_model(5, 3)
    tm.dump(f"{d}/final.mdl")
    ntid = len(tm.id2pdf)
    with kio.TableWriter(f"ark:{d}/ali.ark", kio.write_int_vector) as w:
        for i in range(4):
            w.write(f"utt{i}", rng.randint(1, ntid, int(rng.randint(4, 20)))
                    .astype(np.int32))
    return d


def run_pair(capfd, tmp_path, tool, argv):
    """Runs the JAX tool and the port's on argv, where "{out}" stands for
    each one's own output directory; asserts both give the same exit
    code, files (bytes, with the directory's path taken out), standard
    output and log (timestamps aside); an exception counts as the exit
    code (its type and message). Returns the port's (rc, files, out,
    err)."""
    res = []
    for pkg in ("kaldi_lstm_tpu", "kaldi_lstm_tpu_torch"):
        out_dir = tmp_path / pkg
        out_dir.mkdir()
        main = importlib.import_module(f"{pkg}.tools.{tool}").main
        try:
            rc = main([a.replace("{out}", str(out_dir)) for a in argv])
        except Exception as e:        # noqa: BLE001 -- compared below
            rc = (type(e).__name__, str(e).replace(str(out_dir), ""))
        files = {}
        for root, _, names in os.walk(out_dir):
            for n in names:
                p = os.path.join(root, n)
                files[os.path.relpath(p, out_dir)] = open(p, "rb").read() \
                    .replace(str(out_dir).encode(), b"")
        cap = capfd.readouterr()
        res.append((rc, files, cap.out.replace(str(out_dir), ""),
                    _STAMP.sub("", cap.err).replace(str(out_dir), "")))
    assert res[1] == res[0]
    return res[1]


def read_table(data: bytes, tmp_path) -> dict:
    p = tmp_path / "table.ark"
    p.write_bytes(data)
    return dict(kio.SequentialMatrixReader(f"ark:{p}"))


@pytest.mark.parametrize("extra", [
    [], ["--num-speakers", "3"],
    ["--num-mel-bins", "23", "--noise-rms", "0", "--seed", "4"]])
def test_synth_wavs(capfd, tmp_path, data, extra):
    rc, files, _, _ = run_pair(capfd, tmp_path, "synth_wavs",
                               [f"{data}/final.mdl", f"ark:{data}/ali.ark",
                                "{out}/wav"] + extra)
    assert rc == 0 and len(files) == 5 + bool(extra[:1] ==
                                              ["--num-speakers"])


def test_synth_wavs_refuses_scp(capfd, tmp_path, data):
    rc, *_ = run_pair(capfd, tmp_path, "synth_wavs",
                      [f"{data}/final.mdl", f"scp:{data}/feats.scp",
                       "{out}/wav"])
    assert rc == 1


@pytest.mark.parametrize("spec", ["ark,t:{out}/d.txt", "ark:{out}/d.ark",
                                  "ark,scp:{out}/d.ark,{out}/d.scp"])
@pytest.mark.parametrize("src", ["scp:{d}/wav.scp", "ark:{d}/wav.ark",
                                 "scp:{d}/wavark.scp"])
def test_wav_to_duration(capfd, tmp_path, data, src, spec):
    rc, files, _, err = run_pair(capfd, tmp_path, "wav_to_duration",
                                 [src.format(d=data), spec])
    assert rc == 0 and files and "5 recordings" in err


def test_wav_to_duration_empty(capfd, tmp_path, data):
    open(tmp_path / "none.scp", "w").close()
    rc, *_ = run_pair(capfd, tmp_path, "wav_to_duration",
                      [f"scp:{tmp_path}/none.scp", "ark,t:{out}/d.txt"])
    assert rc == 1


@pytest.mark.parametrize("extra", [
    [], ["--compress", "true"], ["--dither", "0", "--snip-edges", "false"],
    ["--channel", "1", "--window-type", "hamming", "--use-energy", "true"],
    ["--sample-frequency", "8000", "--num-mel-bins", "15",
     "--round-to-power-of-two", "false", "--raw-energy", "false",
     "--use-energy", "true", "--energy-floor", "1.0"],
    ["--use-log-fbank", "false", "--use-power", "false",
     "--remove-dc-offset", "false", "--preemphasis-coefficient", "0",
     "--low-freq", "100", "--high-freq", "-500", "--seed", "3"]])
def test_compute_fbank_feats(capfd, tmp_path, data, extra):
    rc, files, _, err = run_pair(
        capfd, tmp_path, "compute_fbank_feats",
        [f"scp:{data}/wav.scp", "ark,scp:{out}/f.ark,{out}/f.scp",
         "--num-mel-bins", "40"] + extra)
    if "--channel" in extra:      # a1 has no channel 1
        assert rc == ("ValueError", "channel 1 of 1")
        return
    assert rc == 0 and "skipping" in err
    assert set(files) == {"f.ark", "f.scp"}


@pytest.mark.parametrize("spec", ["ark,t:{out}/f.txt", "ark:{out}/f.ark"])
@pytest.mark.parametrize("src", ["ark:{d}/wav.ark", "scp:{d}/wavark.scp",
                                 "scp:{d}/wav16.scp"])
def test_compute_fbank_feats_tables(capfd, tmp_path, data, src, spec):
    rc, files, _, _ = run_pair(capfd, tmp_path, "compute_fbank_feats",
                               [src.format(d=data), spec,
                                "--num-mel-bins", "40"])
    assert rc == 0
    if spec.startswith("ark:"):
        got = read_table(files["f.ark"], tmp_path)
        assert [m.shape[1] for m in got.values()] == [40] * len(got)


def test_compute_fbank_feats_empty(capfd, tmp_path, data):
    (tmp_path / "short.scp").write_text(f"a4 {data}/a4.wav\n")
    rc, *_ = run_pair(capfd, tmp_path, "compute_fbank_feats",
                      [f"scp:{tmp_path}/short.scp", "ark:{out}/f.ark"])
    assert rc == 1


@pytest.mark.parametrize("extra", [
    [], ["--compress", "true", "--num-ceps", "20", "--num-mel-bins", "30"],
    ["--use-energy", "false", "--cepstral-lifter", "0", "--dither", "0"],
    ["--raw-energy", "false", "--energy-floor", "2", "--snip-edges",
     "false", "--window-type", "blackman"]])
def test_compute_mfcc_feats(capfd, tmp_path, data, extra):
    rc, files, _, _ = run_pair(capfd, tmp_path, "compute_mfcc_feats",
                               [f"scp:{data}/wav.scp",
                                "ark,scp:{out}/m.ark,{out}/m.scp"] + extra)
    assert rc == 0 and set(files) == {"m.ark", "m.scp"}


@pytest.mark.parametrize("binary", ["false", "true"])
@pytest.mark.parametrize("src", ["ark:{d}/feats.ark", "scp:{d}/feats.scp",
                                 "ark:{d}/feats.txt"])
def test_compute_cmvn_transform(capfd, tmp_path, data, src, binary):
    rc, files, _, err = run_pair(capfd, tmp_path, "compute_cmvn_transform",
                                 [src.format(d=data), "{out}/t.nnet",
                                  "--binary", binary])
    assert rc == 0 and files["t.nnet"] and "dim 6" in err
    from kaldi_lstm_tpu_torch.models import Nnet
    nnet, params = Nnet.read(str(tmp_path / "kaldi_lstm_tpu_torch/t.nnet"),
                             "cpu")
    x = np.concatenate([m for _, m in kio.SequentialMatrixReader(
        src.format(d=data))])
    y = nnet.propagate(params, torch.from_numpy(x)[None])[0][0].numpy()
    np.testing.assert_allclose(y.mean(0), 0.0, atol=1e-5)
    np.testing.assert_allclose(y.std(0), 1.0, rtol=1e-4)


def test_compute_cmvn_transform_empty(capfd, tmp_path, data):
    rc, files, _, err = run_pair(capfd, tmp_path, "compute_cmvn_transform",
                                 [f"ark:{data}/empty.ark", "{out}/t.nnet"])
    assert rc == 1 and not files and "no features" in err


@pytest.mark.parametrize("extra", [[], ["--spk2utt", "ark:{d}/spk2utt"],
                                   ["--spk2utt", "{d}/spk2utt"]])
@pytest.mark.parametrize("spec", ["ark:{out}/c.ark", "ark,t:{out}/c.txt",
                                  "ark,scp:{out}/c.ark,{out}/c.scp"])
def test_compute_cmvn_stats(capfd, tmp_path, data, extra, spec):
    rc, files, _, err = run_pair(capfd, tmp_path, "compute_cmvn_stats",
                                 [f"scp:{data}/feats.scp", spec]
                                 + [e.format(d=data) for e in extra])
    assert rc == 0 and files
    if extra:                     # utt5 is in no speaker's list
        assert "1 had errors" in err


@pytest.fixture(scope="module")
def stats(data):
    from kaldi_lstm_tpu_torch.tools import compute_cmvn_stats
    assert compute_cmvn_stats.main([f"ark:{data}/feats.ark",
                                    f"ark:{data}/cmvn_utt.ark"]) == 0
    assert compute_cmvn_stats.main([f"ark:{data}/feats.ark",
                                    f"ark,scp:{data}/cmvn_spk.ark,"
                                    f"{data}/cmvn_spk.scp",
                                    f"--spk2utt=ark:{data}/spk2utt"]) == 0
    return data


@pytest.mark.parametrize("extra", [
    [], ["--norm-vars", "true"], ["--reverse", "true"],
    ["--reverse", "true", "--norm-vars", "true"]])
@pytest.mark.parametrize("cmvn", ["ark:{d}/cmvn_utt.ark",
                                  "scp:{d}/cmvn_spk.scp"])
def test_apply_cmvn(capfd, tmp_path, stats, cmvn, extra):
    argv = [cmvn.format(d=stats), f"scp:{stats}/feats.scp",
            "ark:{out}/n.ark"] + extra
    if "spk" in cmvn:
        argv.append(f"--utt2spk=ark:{stats}/utt2spk")
    rc, files, _, err = run_pair(capfd, tmp_path, "apply_cmvn", argv)
    assert rc == 0 and files["n.ark"]
    # per speaker: utt5 maps to a speaker without stats
    assert ("errors on 1" in err) == ("spk" in cmvn)


def test_apply_cmvn_missing_utterance(capfd, tmp_path, stats):
    from kaldi_lstm_tpu_torch.tools import subset_feats
    assert subset_feats.main([f"ark:{stats}/cmvn_utt.ark",
                              f"ark:{tmp_path}/part.ark", "--n", "2"]) == 0
    capfd.readouterr()
    rc, files, _, err = run_pair(capfd, tmp_path, "apply_cmvn",
                                 [f"ark:{tmp_path}/part.ark",
                                  f"ark:{stats}/feats.ark",
                                  "ark,t:{out}/n.txt"])
    assert rc == 0 and "no CMVN stats for utt utt2" in err
    assert "errors on 4" in err


@pytest.mark.parametrize("extra", [
    [], ["--compress", "true"], ["--binary", "false"],
    ["--compress", "true", "--binary", "false"]])
@pytest.mark.parametrize("src", ["ark:{d}/feats.ark", "scp:{d}/feats.scp",
                                 "ark:{d}/feats.txt"])
def test_copy_feats(capfd, tmp_path, data, src, extra):
    rc, files, _, _ = run_pair(capfd, tmp_path, "copy_feats",
                               [src.format(d=data),
                                "ark,scp:{out}/c.ark,{out}/c.scp"] + extra)
    assert rc == (1 if extra == ["--compress", "true", "--binary", "false"]
                  else 0)


def test_copy_feats_text_spec(capfd, tmp_path, data):
    rc, files, _, _ = run_pair(capfd, tmp_path, "copy_feats",
                               [f"ark:{data}/feats.ark", "ark,t:{out}/c.txt"])
    assert rc == 0 and files["c.txt"] == open(f"{data}/feats.txt",
                                              "rb").read()


@pytest.mark.parametrize("extra", [
    [], ["--delta-order", "1", "--delta-window", "1"],
    ["--delta-order", "3", "--delta-window", "3", "--compress", "true"],
    ["--delta-order", "0"]])
def test_add_deltas(capfd, tmp_path, data, extra):
    rc, files, _, _ = run_pair(capfd, tmp_path, "add_deltas",
                               [f"scp:{data}/feats.scp", "ark:{out}/d.ark"]
                               + extra)
    assert rc == 0 and files["d.ark"]


@pytest.mark.parametrize("ctx", [("4", "4"), ("0", "2"), ("3", "0"),
                                 ("-1", "2"), ("1", "1", "--compress")])
def test_splice_feats(capfd, tmp_path, data, ctx):
    rc, files, _, _ = run_pair(capfd, tmp_path, "splice_feats",
                               [f"ark:{data}/feats.ark", "ark:{out}/s.ark",
                                "--left-context", ctx[0],
                                "--right-context", ctx[1]]
                               + (["--compress", "true"] if ctx[2:] else []))
    if ctx[0] == "-1":
        assert rc == 1 and not files
        return
    assert rc == 0
    if ctx[2:]:
        return
    # the port's <Splice> component computes the same frames
    from kaldi_lstm_tpu_torch.models.components import Splice
    left, right = int(ctx[0]), int(ctx[1])
    comp = Splice(6, 6 * (left + right + 1), list(range(-left, right + 1)))
    got = read_table(files["s.ark"], tmp_path)
    for key, m in kio.SequentialMatrixReader(f"ark:{data}/feats.ark"):
        y = comp.apply({}, torch.from_numpy(m.copy())[None])[0][0].numpy()
        assert np.array_equal(got[key], y)


@pytest.mark.parametrize("extra", [[], ["--length-tolerance", "1"],
                                   ["--length-tolerance", "5",
                                    "--compress", "true"]])
def test_paste_feats(capfd, tmp_path, data, extra):
    """utt2 has no second stream (a missing utterance: skipped), utt1's
    is a frame short and utt4's three (a length mismatch: skipped unless
    within --length-tolerance); the 6- and 13-dim streams paste to 19."""
    rc, files, _, err = run_pair(capfd, tmp_path, "paste_feats",
                                 [f"ark:{data}/feats.ark",
                                  f"ark:{data}/second.ark",
                                  "ark:{out}/p.ark"] + extra)
    assert rc == 0 and "no record for utt2 in input 2" in err
    tol = int(extra[1]) if extra else 0
    assert f"{1 + (tol < 1) + (tol < 3)} had errors" in err
    if "--compress" not in extra:
        got = read_table(files["p.ark"], tmp_path)
        assert {m.shape[1] for m in got.values()} == {19}


@pytest.mark.parametrize("argv", [
    ["ark:{d}/feats.ark", "ark:{out}/p.ark"],
    ["ark:{d}/feats.ark", "scp:{d}/feats.scp", "ark:{out}/p.ark"],
    ["ark:{d}/second.ark", "ark:{d}/feats.txt", "scp:{d}/feats.scp",
     "ark,t:{out}/p.txt"]])
def test_paste_feats_arity_and_tables(capfd, tmp_path, data, argv):
    rc, files, _, _ = run_pair(capfd, tmp_path, "paste_feats",
                               [a.replace("{d}", data) for a in argv])
    assert rc == (1 if len(argv) == 2 else 0)


@pytest.mark.parametrize("sel,extra", [
    ("0,2-4", []), ("5-1,0", []), ("3", []), ("0-6", []), ("x", []),
    ("-1", []), ("1,1,0", ["--compress", "true"])])
def test_select_feats(capfd, tmp_path, data, sel, extra):
    rc, *_ = run_pair(capfd, tmp_path, "select_feats",
                      [sel, f"scp:{data}/feats.scp", "ark:{out}/s.ark"]
                      + extra)
    assert rc == (1 if sel in ("0-6", "x", "-1") else 0)


@pytest.mark.parametrize("extra", [
    ["--n", "3"], ["--n", "0"], ["--include", "{d}/keys"],
    ["--exclude", "{d}/keys", "--compress", "true"],
    ["--include", "{d}/keys", "--exclude", "{d}/keys"]])
def test_subset_feats(capfd, tmp_path, data, extra):
    rc, *_ = run_pair(capfd, tmp_path, "subset_feats",
                      [f"scp:{data}/feats.scp",
                       "ark,scp:{out}/s.ark,{out}/s.scp"]
                      + [e.format(d=data) for e in extra])
    both = "--include" in extra and "--exclude" in extra
    assert rc == (1 if both or extra == ["--n", "0"] else 0)


def scp_entry(data, n=0):
    with open(f"{data}/feats.scp") as f:
        return f.read().split("\n")[n].split()[1]


@pytest.mark.parametrize("argv", [
    ["scp:{d}/feats.scp", "ark,t:{out}/l.txt"],
    ["ark:{d}/feats.ark", "ark:{out}/l.ark"],
    ["ark:{d}/feats.txt"], ["{entry}"], ["ark:{d}/empty.ark", "ark:{out}/l"]])
def test_feat_to_len(capfd, tmp_path, data, argv):
    rc, files, out, _ = run_pair(capfd, tmp_path, "feat_to_len", [
        a.replace("{d}", data).replace("{entry}", scp_entry(data, 1))
        for a in argv])
    assert rc == (1 if "empty" in argv[0] else 0)
    assert (out != "") == (len(argv) == 1)


@pytest.mark.parametrize("argv,rc_want,printed", [
    (["scp:{d}/feats.scp"], 0, True), (["ark:{d}/feats.ark", "-"], 0, True),
    (["scp:{d}/feats.scp", "ark,t:{out}/d.txt"], 0, False),
    (["{entry}"], 0, True), (["{entry}", "{out}/dim"], 0, False),
    (["ark:{d}/empty.ark"], 1, False), (["{entry}", "ark:{out}/d.ark"], 1,
                                         False)])
def test_feat_to_dim(capfd, tmp_path, data, argv, rc_want, printed):
    rc, files, out, _ = run_pair(capfd, tmp_path, "feat_to_dim", [
        a.replace("{d}", data).replace("{entry}", scp_entry(data))
        for a in argv])
    assert rc == rc_want and (out == "6\n") == printed


@pytest.mark.parametrize("spec", ["ark:{out}/seg.ark",
                                  "ark,scp:{out}/seg.ark,{out}/seg.scp",
                                  "ark,t:{out}/seg.ark"])
@pytest.mark.parametrize("src", ["scp:{d}/wav.scp", "ark:{d}/wav.ark"])
def test_extract_segments(capfd, tmp_path, data, src, spec):
    """Cuts with and without a channel, an end of 0 (to the end), a
    channel the recording lacks, an overshoot within and beyond
    --max-overshoot, a too-short cut and a missing recording."""
    rc, files, _, err = run_pair(capfd, tmp_path, "extract_segments",
                                 [src.format(d=data), f"{data}/segments",
                                  spec, "--max-overshoot", "0.2"])
    if ",t" in spec:
        assert rc[0] == "ValueError" and "binary ark only" in rc[1]
        return
    assert rc == 0 and "recording zz not present" in err
    assert "Extracted 6 segments; 4 errors" in err


def test_extract_segments_bad_file(capfd, tmp_path, data):
    rc, files, _, err = run_pair(capfd, tmp_path, "extract_segments",
                                 [f"scp:{data}/wav.scp",
                                  f"{data}/bad_segments", "ark:{out}/s.ark"])
    assert rc == 1 and not files and "bad times" in err


def test_extract_segments_into_fbank(capfd, tmp_path, data):
    """The cut pieces as a wav-ark feed compute_fbank_feats, as in the
    upstream pipe."""
    rc, files, _, _ = run_pair(capfd, tmp_path, "extract_segments",
                               [f"scp:{data}/wav.scp", f"{data}/segments",
                                "ark:{out}/seg.ark"])
    p = tmp_path / "seg.ark"
    p.write_bytes(files["seg.ark"])
    (tmp_path / "f").mkdir()
    rc, files, _, _ = run_pair(capfd, tmp_path / "f", "compute_fbank_feats",
                               [f"ark:{p}", "ark:{out}/f.ark"])
    assert rc == 0 and files["f.ark"]


@pytest.mark.parametrize("extra", [
    [], ["--num-utts", "4", "--feat-dim", "5", "--num-classes", "7",
         "--min-len", "3", "--max-len", "9", "--seed", "2"]])
def test_make_synth_data(capfd, tmp_path, extra):
    rc, files, _, _ = run_pair(capfd, tmp_path, "make_synth_data",
                               ["--dir", "{out}/d", "--num-utts", "3",
                                "--max-len", "60"] + extra)
    assert rc == 0 and set(files) == {"d/feats.ark", "d/feats.scp",
                                      "d/post.ark", "d/ali.ark"}


@pytest.mark.parametrize("extra", [
    [], ["--num-phones", "3", "--states-per-phone", "2", "--feat-dim", "4",
         "--self-loop-prob", "0.3", "--emission-noise", "0.1",
         "--seed", "5", "--mean-seed", "1"]])
def test_make_hmm_synth_data(capfd, tmp_path, extra):
    rc, files, _, _ = run_pair(capfd, tmp_path, "make_hmm_synth_data",
                               ["--dir", "{out}/d", "--num-utts", "4"]
                               + extra)
    assert rc == 0 and set(files) == {"d/final.mdl", "d/feats.ark",
                                      "d/feats.scp", "d/ali.ark", "d/text"}
