"""The host-side flags of svinet_torch's link-sampling CLI against the JAX
package's, on the CPU: -init-communities, -load-test-sets, -preprocess,
-profile, and the time budget of LinkSampling.infer(max_seconds).

Both packages read the same planted graph with the same seed, so the
heldout split, the initial gamma and the files written before the first
sweep are the same bit for bit; likelihood rows agree to f32 summation
order (1e-4 relative, tests/test_torch_engine.py)."""

import filecmp
import json
import os
import shutil

import numpy as np
import pytest
import torch

from svinet_tpu.cli import main as jax_main, parse_args
from svinet_tpu.graph import Network
from svinet_tpu.svi.linksampling import LinkSampling as JaxLS
from svinet_torch.cli import main as torch_main
from svinet_torch.svi.linksampling import LinkSampling
from svinet_torch.synth import write_planted

N, K, DEG, GRAPH_SEED = 400, 4, 16, 2
LIKELIHOOD_COLS = [2, 4, 6, 8, 9, 10]


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    d = tmp_path_factory.mktemp("planted")
    net, gt = write_planted(str(d), N, K, DEG, GRAPH_SEED)
    # the planted cover as -init-communities reads it: one community a
    # line, of external node ids
    comms = {}
    for line in open(gt):
        node, c = line.split()
        comms.setdefault(int(c), []).append(node)
    init = d / "init-communities.txt"
    init.write_text("".join("\t".join(m) + "\n" for _, m in sorted(
        comms.items())))
    return d, net, gt, str(init)


def _args(net, label, *flags):
    return ["-file", net, "-n", str(N), "-k", str(K), "-link-sampling",
            "-seed", "1", "-label", label, *flags]


def _engines(net, *flags):
    """Both packages' engines on the same parsed flags."""
    out = []
    for label in ("jax", "torch"):
        cfg = parse_args(_args(net, label, *flags))
        nw = Network(cfg)
        nw.read(cfg.datfname)
        nw.drop_singles()
        out.append(JaxLS(cfg, nw) if label == "jax"
                   else LinkSampling(cfg, nw, torch.device("cpu")))
    return out


def test_init_communities_gamma_and_memberships(planted, tmp_path,
                                                monkeypatch):
    """The initial gamma bit for bit, and init_memberships.txt byte for
    byte."""
    _, net, _, init = planted
    monkeypatch.chdir(tmp_path)
    jax_eng, eng = _engines(net, "-init-communities", init)
    g = eng.gamma.numpy()
    np.testing.assert_array_equal(g, np.asarray(jax_eng.gamma))
    np.testing.assert_array_equal(eng.lam.numpy(), np.asarray(jax_eng.lam))
    assert filecmp.cmp(jax_eng.cfg.file_str("init_memberships.txt"),
                       eng.cfg.file_str("init_memberships.txt"),
                       shallow=False)
    # each row sums to alpha * K + the node's degree over all links
    deg = np.diff(eng.network.row_ptr)
    np.testing.assert_allclose(g.sum(1), deg + 1.0, rtol=1e-5)
    # planted blocks are runs of N // K external ids
    block = np.asarray(eng.network.seq2id) // (N // K)
    assert (g.argmax(1) == block).mean() > 0.99
    eng.close()


def _test_pair_files(where, net):
    """uniform- and biased-heldout-pairs.txt of external ids in `where`."""
    ids = np.unique(np.loadtxt(net, dtype=np.int64).ravel())
    rng = np.random.default_rng(4)
    for name, m in (("uniform", 60), ("biased", 40)):
        pairs = rng.choice(ids, (m, 2))
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        np.savetxt(where / f"{name}-heldout-pairs.txt", pairs, fmt="%d")


def test_load_test_sets_files_match_jax(planted, tmp_path, monkeypatch):
    _, net, _, _ = planted
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    out = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        where = tmp_path / name
        where.mkdir()
        _test_pair_files(where, net)
        monkeypatch.chdir(where)
        assert main(_args(net, name, "-load-test-sets", "-max-iterations",
                          "6")) == 0
        out[name] = where / f"n{N}-k{K}-{name}-seed1-linksampling"
    assert sorted(os.listdir(out["torch"])) == sorted(os.listdir(out["jax"]))
    for set_name in ("uniform", "biased"):
        assert filecmp.cmp(out["jax"] / f"{set_name}-test-pairs.txt",
                           out["torch"] / f"{set_name}-test-pairs.txt",
                           shallow=False)
        t, j = (np.loadtxt(out[x] / f"{set_name}-hol.txt", ndmin=2)
                for x in ("torch", "jax"))
        assert t.shape == j.shape and len(t) == 7      # iterations 0 to 6
        np.testing.assert_array_equal(t[:, [0, 3, 5, 7]], j[:, [0, 3, 5, 7]])
        np.testing.assert_allclose(t[:, LIKELIHOOD_COLS],
                                   j[:, LIKELIHOOD_COLS], rtol=1e-4)
        ta, ja = (np.loadtxt(out[x] / f"{set_name}_auc.txt", ndmin=2)
                  for x in ("torch", "jax"))
        np.testing.assert_array_equal(ta[:, 0], ja[:, 0])
        # three decimals of P(link): one unit apart where the f32 value
        # sits on a rounding boundary
        np.testing.assert_allclose(ta[:, 1], ja[:, 1], atol=1.5e-3)


def test_load_test_sets_without_files_exits(planted, tmp_path, monkeypatch):
    _, net, _, _ = planted
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="heldout-pairs.txt"):
        torch_main(_args(net, "none", "-load-test-sets"))


def test_preprocess_neighbors_bin_matches_jax(planted, tmp_path,
                                              monkeypatch):
    _, net, _, _ = planted
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    got = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        where = tmp_path / name
        where.mkdir()
        monkeypatch.chdir(where)
        assert main(["-file", net, "-n", str(N), "-k", str(K),
                     "-preprocess", "-label", "pp"]) == 0
        got[name] = where / f"n{N}-k{K}-pp-infset" / "neighbors.bin"
    assert got["torch"].stat().st_size > 0
    assert filecmp.cmp(got["jax"], got["torch"], shallow=False)


def test_profile_writes_a_trace(planted, tmp_path, monkeypatch):
    _, net, _, _ = planted
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    assert torch_main(_args(net, "prof", "-profile", "trace",
                            "-max-iterations", "2")) == 0
    trace = json.load(open(tmp_path / "trace" / "svinet_torch_trace.json"))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("softmax" in name for name in names), sorted(names)[:20]
    assert (tmp_path / f"n{N}-k{K}-prof-seed1-linksampling"
            / "gamma.txt").exists()


def test_infer_max_seconds_zero_stops_after_first_report(planted, tmp_path,
                                                         monkeypatch):
    """A budget of 0 s: both packages write the iteration-0 report, then
    stop before the first sweep and write the model files."""
    _, net, _, _ = planted
    monkeypatch.chdir(tmp_path)
    jax_eng, eng = _engines(net)
    for e in (jax_eng, eng):
        e.infer(max_seconds=0)
    eng.close()
    for e in (jax_eng, eng):
        rows = np.loadtxt(e.cfg.file_str("heldout.txt"), ndmin=2)
        assert rows[:, 0].tolist() == [0.0]
        assert os.path.exists(e.cfg.file_str("gamma.txt"))
    np.testing.assert_array_equal(eng.gamma.numpy(),
                                  np.asarray(jax_eng.gamma))


def test_infer_max_seconds_none_runs_to_max_iterations(planted, tmp_path,
                                                       monkeypatch):
    _, net, _, _ = planted
    monkeypatch.chdir(tmp_path)
    from svinet_torch.cli import parse_args as torch_parse_args
    from svinet_torch.graph import Network as TorchNetwork
    cfg = torch_parse_args(_args(net, "budget", "-max-iterations", "3"))
    nw = TorchNetwork(cfg)
    nw.read(cfg.datfname)
    nw.drop_singles()
    eng = LinkSampling(cfg, nw, torch.device("cpu"))
    try:
        eng.infer(max_seconds=3600)
    finally:
        eng.close()
    rows = np.loadtxt(eng.cfg.file_str("heldout.txt"), ndmin=2)
    assert rows[:, 0].tolist() == [0.0, 1.0, 2.0, 3.0]
    shutil.rmtree(eng.cfg.outdir)
