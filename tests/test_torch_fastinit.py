"""FastInit (-findk) in the port against the JAX package, on the CPU: the
vote (kernel 12's plain version) bit for bit, the sparse pi and the
overlap pass (kernel 13's plain version) at 1e-6 with equal ids, the
vectorised community grouping against the JAX engine's loop, and whole
CLI runs: alone, at a width above 64, cut and -resume'd, and under
-mesh 2 (one process, as the JAX CLI runs it).

FastInit draws nothing after the held-out splits, and its vote is all
integers, so the two packages' labels, ids and counts are equal after
every sweep; only the overlap's f32 sums differ in order. The community
files, groups.txt and mutual.txt are held byte for byte, the held-out
rows at 1e-5."""

import filecmp
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svinet_tpu.cli import main as jax_main
from svinet_tpu.ops.edges import pad_edges
from svinet_tpu.svi import fastinit as jfi
from svinet_tpu.svi.base import EngineBase as JEngineBase
from svinet_torch.cli import main as torch_main, parse_args
from svinet_torch.ops.edges import build_adjacency
from svinet_torch.parallel import mesh
from svinet_torch.svi import fastinit as fi
from svinet_torch.svi.base import EngineBase
from svinet_torch.synth import write_planted

TOL = dict(rtol=1e-6, atol=1e-6)
ROW_TOL = dict(rtol=1e-5, atol=1e-5)
N = 300


@pytest.fixture(autouse=True)
def one_thread():
    """Many small tensor operations: one intra-op thread keeps a loaded
    machine from slowing them tenfold (the results do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    d = tmp_path_factory.mktemp("planted")
    return write_planted(str(d), 400, 4, 16, 2)


def _graph(seed):
    """N nodes: random links among the first 280, node 7 a hub linked to
    270 of them (more than kernel 12's warp takes), the last 20
    isolated."""
    rng = np.random.default_rng(seed)
    e = rng.integers(0, 280, size=(900, 2))
    hub = np.stack([np.full(270, 7), np.r_[0:7, 8:271]], 1)
    e = np.sort(np.concatenate([e, hub]), 1)
    e = e[e[:, 0] != e[:, 1]]
    return np.unique(e, axis=0).astype(np.int32)


def _jax_vote(labels, links, width):
    pe, pm = pad_edges(links, 64)
    ids, cnt = jfi.vote_topk(jnp.asarray(labels), jnp.asarray(pe),
                             jnp.asarray(pm), N, width)
    return np.asarray(ids), np.asarray(cnt)


@pytest.mark.parametrize("width", [8, 64])
def test_vote_topk_matches_jax(width):
    """Labels from 12 values, so many counts tie (count descending, then
    label ascending); the hub's 270 votes; isolated nodes all sentinel."""
    links = _graph(0)
    labels = np.random.default_rng(1).integers(0, 12, N).astype(np.int32)
    ji, jc = _jax_vote(labels, links, width)
    ti, tc = fi.vote_topk(torch.tensor(labels), build_adjacency(links, N),
                          N, width)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tc.numpy(), jc)
    assert (ji[280:] == N).all() and (jc[280:] == 0).all()
    assert 0 < jc[7].sum() <= 270 and jc[7, 0] > 20
    # ties broken by the lower label
    tied = (jc[:, :-1] == jc[:, 1:]) & (jc[:, 1:] > 0)
    assert tied.any()
    assert (ji[:, :-1][tied] < ji[:, 1:][tied]).all()


def test_label_propagation_matches_jax():
    """Three sweeps from every node its own label, exactly."""
    links = _graph(2)
    pe, pm = pad_edges(links, 64)
    lab = jnp.arange(N, dtype=jnp.int32)
    for _ in range(3):
        ids, _ = jfi.vote_topk(lab, jnp.asarray(pe), jnp.asarray(pm), N, 8)
        lab = jnp.where(ids[:, 0] < N, ids[:, 0], lab)
    got = fi.label_propagation(build_adjacency(links, N), N, 8, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(lab))


def _rows(seed, n, w):
    """(ids, cnt): each row a random number of distinct ids from a small
    universe (a tenth of the rows none), counts descending, the sentinel
    n and 0 past them."""
    rng = np.random.default_rng(seed)
    universe = max(2 * w, 16)
    real = rng.integers(0, w + 1, n)
    real[rng.random(n) < 0.1] = 0
    ids = np.stack([rng.permutation(universe)[:w] for _ in range(n)]
                   ).astype(np.int32)
    cnt = -np.sort(-rng.integers(1, 30, (n, w)), 1).astype(np.float32)
    past = np.arange(w)[None, :] >= real[:, None]
    ids[past] = n
    cnt[past] = 0.0
    return ids, cnt


@pytest.mark.parametrize("width", [8, 64, 130])
def test_sparse_pi_and_overlap_match_jax(width):
    n = 200
    ids, cnt = _rows(width, n, width)
    rng = np.random.default_rng(width + 1)
    pairs = rng.integers(0, n, (700, 2)).astype(np.int32)
    pairs[:5, 1] = pairs[:5, 0]
    pi_j = np.asarray(jfi.sparse_pi(jnp.asarray(ids), jnp.asarray(cnt),
                                    jnp.float32(0.01)))
    pi_t = fi.sparse_pi(torch.tensor(ids), torch.tensor(cnt), 0.01)
    np.testing.assert_allclose(pi_t.numpy(), pi_j, **TOL)
    js, jm, jid = (np.asarray(a) for a in jfi.overlap_stats(
        jnp.asarray(ids), jnp.asarray(pi_j), pairs))
    ts, tm, tid = (a.numpy() for a in fi.overlap_stats(
        torch.tensor(ids), torch.tensor(pi_j), torch.tensor(pairs)))
    np.testing.assert_allclose(ts, js, **TOL)
    np.testing.assert_allclose(tm, jm, **TOL)
    np.testing.assert_array_equal(tid, jid)
    assert (js > 0).any() and (js == 0).any()


def test_overlap_plain_at_width_4097_matches_jax():
    """overlap_stats_plain at width 4,097 (past the width whose table
    kernel 13 keeps in shared memory; the card takes its tables in device
    scratch there) against JAX's _overlap_block on pairs sharing most of
    their ids: two pairs, since JAX's (B, w, w) intermediate is 67 MB a
    pair. The plain pass takes them in blocks of one."""
    w, n = 4_097, 4_200
    rng = np.random.default_rng(41)
    # rows of distinct ids below n (ids are node labels, n the sentinel),
    # the first four drawn apart, the rest a copy of row 0
    ids = np.empty((n, w), np.int32)
    for r in range(4):
        ids[r] = rng.permutation(n)[:w]
    ids[4:] = ids[0]
    ids[:4, -3:] = n                            # a few empty slots
    pi = np.broadcast_to(rng.random(w).astype(np.float32) / w,
                         (n, w)).copy()
    pairs = np.array([[0, 1], [2, 3]], np.int32)
    js, jm, jid = (np.asarray(a) for a in jfi._overlap_block(
        jnp.asarray(ids), jnp.asarray(pi), jnp.asarray(pairs)))
    ts, tm, tid = (a.numpy() for a in fi.overlap_stats_plain(
        torch.tensor(ids), torch.tensor(pi), torch.tensor(pairs), block=1))
    assert (js > 0).all()
    np.testing.assert_allclose(ts, js, **TOL)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tid, jid)


def test_overlap_width_has_no_limit():
    """No width limit is left: the wrapper takes width 5,000 (past 4,096
    the card keeps the tables in device scratch, sized by the kernel's own
    query). On CPU tensors a pair of rows sharing two ids among empty slots
    gives their products' sum, the largest and its id."""
    assert not hasattr(fi, "OVERLAP_MAX_W")
    n, w = 4, 5_000
    ids = torch.full((n, w), n, dtype=torch.int32)
    pi = torch.zeros((n, w))
    ids[0, [0, 7, 4_999]] = torch.tensor([1, 2, 3], dtype=torch.int32)
    pi[0, [0, 7, 4_999]] = torch.tensor([0.5, 0.25, 0.2])
    ids[1, [10, 4_000, 4_998]] = torch.tensor([3, 2, 0], dtype=torch.int32)
    pi[1, [10, 4_000, 4_998]] = torch.tensor([0.5, 0.25, 0.125])
    ssum, mx, mid = fi.overlap_stats(ids, pi,
                                     torch.tensor([[0, 1]], dtype=torch.int32))
    assert float(ssum[0]) == pytest.approx(0.2 * 0.5 + 0.25 * 0.25)
    assert float(mx[0]) == pytest.approx(0.2 * 0.5)
    assert int(mid[0]) == 3


def test_overlap_without_a_shared_id_gives_ids_p0():
    """No shared id: sum 0, max 0 and p's first id, the sentinel where p's
    row is empty (the argmax of an all-zero block)."""
    n, w = 10, 4
    ids = np.full((n, w), n, np.int32)
    cnt = np.zeros((n, w), np.float32)
    ids[1, :2], cnt[1, :2] = [3, 5], [2, 1]
    ids[2, :2], cnt[2, :2] = [4, 6], [3, 1]
    ids[3, :3], cnt[3, :3] = [6, 5, 3], [2, 2, 1]
    pi = fi.sparse_pi(torch.tensor(ids), torch.tensor(cnt), 0.5)
    pairs = torch.tensor([[1, 2], [0, 1], [2, 3], [1, 3]], dtype=torch.int32)
    s, m, mid = fi.overlap_stats(torch.tensor(ids), pi, pairs)
    js, jm, jid = (np.asarray(a) for a in jfi.overlap_stats(
        jnp.asarray(ids), jnp.asarray(pi.numpy()), pairs.numpy()))
    np.testing.assert_array_equal(mid.numpy(), jid)
    np.testing.assert_array_equal(mid.numpy()[:2], [3, n])
    np.testing.assert_array_equal(s.numpy()[:2], [0.0, 0.0])
    np.testing.assert_allclose(s.numpy(), js, **TOL)
    np.testing.assert_allclose(m.numpy(), jm, **TOL)


def test_link_groups_matches_the_jax_loop():
    rng = np.random.default_rng(5)
    n = 60
    tl = np.sort(rng.integers(0, n, (500, 2)), 1).astype(np.int32)
    ssum = rng.random(500).astype(np.float32)
    ssum[::7] = 0.0
    mv = (ssum * rng.random(500)).astype(np.float32)
    mi = rng.integers(0, 9, 500).astype(np.int32)
    norm = np.where(ssum > 0, mv / np.maximum(ssum, 1e-30), 0.0)
    want = {}
    for (p, q), c in zip(tl[norm >= 0.5], mi[norm >= 0.5]):
        want.setdefault(int(c), set()).update((int(p), int(q)))
    got = fi.link_groups(tl, ssum, mv, mi, n, 0.5)
    assert got == {c: sorted(v) for c, v in want.items()}


def _cli(main, cwd, net, gt, label, flags):
    os.chdir(cwd)
    assert main(["-file", net, "-n", "400", "-k", "4", "-nmi", gt, "-seed",
                 "1", "-label", label, "-findk", *flags]) == 0
    out = [p for p in pathlib.Path(cwd).iterdir()
           if p.name.startswith(f"n400-k4-{label}-seed1")]
    assert len(out) == 1, out
    return out[0]


def _held_to_jax(ours, theirs):
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    for name in ("communities.txt", "communities_size.txt", "groups.txt",
                 "mutual.txt"):
        assert filecmp.cmp(ours / name, theirs / name, shallow=False), name
    for name in ("heldout.txt", "validation.txt", "max.txt"):
        a, b = (np.loadtxt(p / name, ndmin=2) for p in (ours, theirs))
        assert a.shape == b.shape and len(a), name
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        np.testing.assert_allclose(a[:, 2:], b[:, 2:], **ROW_TOL)


@pytest.mark.parametrize("flags", [[], ["-findk-width", "130"]])
def test_cli_findk_matches_jax(planted, tmp_path, monkeypatch, flags):
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    net, gt = planted
    out = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        (tmp_path / name).mkdir()
        out[name] = _cli(main, tmp_path / name, net, gt, name, flags)
    _held_to_jax(out["torch"], out["jax"])
    # int(log10(400)) + 1 sweeps, a report after each
    assert len(np.loadtxt(out["torch"] / "heldout.txt")) == 3


class Cut(Exception):
    pass


def _cut_after(base, iteration):
    orig = base._end_of_report

    def cut(self):
        orig(self)
        if self.iteration >= iteration:
            raise Cut
    return orig, cut


def test_cli_findk_resume(planted, tmp_path, monkeypatch):
    """Both CLIs cut after the report of sweep 1 with a checkpoint at each
    report, then -resume'd: the resumed runs write the uninterrupted JAX
    run's files (nothing is drawn after the splits)."""
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    net, gt = planted
    out = {}
    for name, main, base in (("jax", jax_main, JEngineBase),
                             ("torch", torch_main, EngineBase)):
        (tmp_path / name).mkdir()
        orig, cut = _cut_after(base, 1)
        monkeypatch.setattr(base, "_end_of_report", cut)
        with pytest.raises(Cut):
            _cli(main, tmp_path / name, net, gt, name,
                 ["-checkpoint-freq", "1e-9"])
        monkeypatch.setattr(base, "_end_of_report", orig)
        out[name] = _cli(main, tmp_path / name, net, gt, name, ["-resume"])
        rows = np.loadtxt(out[name] / "heldout.txt")[:, 0]
        np.testing.assert_array_equal(rows, [1, 2, 3])
    (tmp_path / "whole").mkdir()
    whole = _cli(jax_main, tmp_path / "whole", net, gt, "whole", [])
    _held_to_jax(out["torch"], out["jax"])
    for name in ("communities.txt", "groups.txt"):
        assert filecmp.cmp(out["torch"] / name, whole / name,
                           shallow=False), name


def test_findk_mesh_runs_one_process(planted, tmp_path, monkeypatch):
    """-findk -mesh 2 (with -link-sampling too: FastInit dispatches first)
    runs one process on one device, as the JAX CLI does
    (svinet_tpu/cli.py:367-372): the files of the run without -mesh."""
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    for flags in (["-findk"], ["-findk", "-link-sampling"],
                  ["-findk", "-mesh-rowshard"]):
        cfg = parse_args(["-file", "x", "-n", "10", "-k", "4", "-mesh", "2",
                          *flags])
        assert mesh.wants_mesh(cfg) is False, flags

    def no_launch(*args, **kwargs):
        raise AssertionError("-findk spawned mesh ranks")

    monkeypatch.setattr(mesh, "launch", no_launch)
    net, gt = planted
    out = {}
    for name, flags in (("plain", []), ("mesh", ["-mesh", "2"])):
        (tmp_path / name).mkdir()
        out[name] = _cli(torch_main, tmp_path / name, net, gt, "r", flags)
    for name in ("communities.txt", "groups.txt", "mutual.txt"):
        assert filecmp.cmp(out["plain"] / name, out["mesh"] / name,
                           shallow=False), name
