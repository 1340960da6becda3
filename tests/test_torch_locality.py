"""-mesh-locality in the port (parallel/locality.py, mesh.LocalityComm,
the engine's locality branch) against the JAX package.

The layout is a numpy copy and must be exact; the sweep on two gloo ranks
(tests/mesh_rank_cases.py) is held to JAX's make_mesh_trace_sweep with
locality=True on two of the virtual CPU devices at 1e-4; the CLI's
`-mesh 2 -mesh-locality` to the JAX CLI's run of the same flags at the
JAX CLI's own tolerances, with the same stop; the one-rank locality run
to the one-rank row-sharded run on the same order bit for bit; and the
locality order is the same in every process that computes it."""

import json
import os
import subprocess
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import mesh_rank_cases as cases
from svinet_tpu.cli import main as jax_main
from svinet_tpu.parallel import locality as jlocality
from svinet_tpu.parallel import mesh as jmesh
from svinet_tpu.svi.sweep_math import LSConsts
from svinet_torch.config import Config
from svinet_torch.graph import Network
from svinet_torch.parallel import locality, mesh
from svinet_torch.svi.linksampling import LinkSampling
from svinet_torch.synth import write_planted

TOL = dict(rtol=1e-4, atol=1e-4)
# -bf16 rows: the two digammas may round a value to neighbouring bf16
# steps (tests/test_torch_mesh.py)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
GAMMA_TOL = dict(rtol=2e-4, atol=2e-3)
HELDOUT_TOL = dict(rtol=5e-4, atol=5e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _edges(n, m, seed):
    """m random distinct canonical links on n nodes."""
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, (m, 2))
    e = e[e[:, 0] != e[:, 1]]
    keys = np.unique(np.minimum(e[:, 0], e[:, 1]) * n
                     + np.maximum(e[:, 0], e[:, 1]))
    return np.stack([keys // n, keys % n], 1).astype(np.int32)


@pytest.mark.parametrize("d", [2, 3, 5])
def test_layout_is_the_jax_layout(d):
    """locality_edge_layout equals the JAX package's at d = 2, 3 and 5,
    and keeps its invariants (tests/test_sharding.py:639): every link on
    one rank owning an end, at most one end remote, and the remapped ends
    decoding back to the links through [owned | boundary table]."""
    n = 90
    edges = _edges(n, 500, d)
    got = locality.locality_edge_layout(edges, n, d, 16)
    want = jlocality.locality_edge_layout(edges, n, d, 16)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3]
    out, mask, exp_idx, info = got
    rows_per, xmax, per = info["rows_per"], info["xmax"], info["per_shard"]
    assert int(mask.sum()) == len(edges)
    decoded = []
    for s in range(d):
        chunk = out[s * per:(s + 1) * per][mask[s * per:(s + 1) * per] > 0]
        assert (chunk[:, 0] != chunk[:, 1]).all()
        assert ((chunk >= rows_per).sum(1) <= 1).all()

        def dec(x):
            if x < rows_per:
                return s * rows_per + x
            slot = x - rows_per
            return slot // xmax * rows_per + exp_idx[slot]

        for p, q in chunk:
            a, b = dec(p), dec(q)
            assert min(a, b) // rows_per == s or max(a, b) // rows_per == s
            decoded.append((min(a, b), max(a, b)))
    np.testing.assert_array_equal(np.array(sorted(decoded)), edges)


@pytest.fixture(scope="module")
def loc_ranks():
    """The locality cases of mesh_rank_cases on two gloo ranks."""
    d = tempfile.mkdtemp(prefix="loc_cases_")
    init = "file://" + os.path.join(d, "rendezvous")
    ctx = torch.multiprocessing.start_processes(
        cases.run_locality, args=(2, init, d), nprocs=2, join=False,
        start_method="spawn")
    while not ctx.join():
        pass
    return [torch.load(os.path.join(d, f"rank{r}.pt")) for r in range(2)]


def _jax_locality(n_batches, bf16):
    """JAX's make_mesh_trace_sweep(locality=True) on the same inputs and
    layout: (gamma (n,K), lam, trace, mphi (n,K))."""
    edges, deg, gamma0, lam0, consts, vp, vy = cases.sweep_inputs()
    n, k = gamma0.shape
    n_pad, (es, ms, exp_idx, info) = cases.locality_layout(2)
    jm = jmesh.make_mesh(2)
    row = NamedSharding(jm, P("edges"))
    es_d, ms_d = jmesh.device_put_sharded_edges(jm, es, ms)
    gam = np.full((n_pad, k), consts[0], np.float32)
    gam[:n] = gamma0
    dg = np.zeros(n_pad, np.float32)
    dg[:n] = deg
    g_in, d_in, m_in, exp_d = (
        jmesh.global_put(a, row)
        for a in (gam, dg, np.zeros((n_pad, k), np.float32), exp_idx))
    hidx, pp, yy, ww, nb = jmesh.rowshard_heldout_layout(vp, vy, n_pad, 2)
    ho = tuple(jmesh.global_put(a, row) for a in (hidx, pp, yy, ww))
    alpha, eta0, eta1, ones, nn = consts
    c = LSConsts(alpha=jnp.float32(alpha),
                 eta=jnp.asarray([eta0, eta1], jnp.float32),
                 ones=jnp.float32(ones), n_nodes=jnp.float32(nn))
    fn = jmesh.make_mesh_trace_sweep(jm, info["per_shard"] // cases.BLOCK,
                                     fused=True, rowshard=True,
                                     locality=True)
    g, l, m, trace = fn(g_in, jnp.asarray(lam0), m_in, es_d, ms_d, d_in, c,
                        jnp.float32(1.0), (*ho, jnp.float32(cases.EPS), nb),
                        cases.SWEEPS, n_batches, bf16, exp_idx=exp_d)
    return (np.asarray(g)[:n], np.asarray(l), np.asarray(trace),
            np.asarray(m)[:n])


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n_batches", [1, 3])
def test_locality_sweep_matches_jax(loc_ranks, n_batches, bf16):
    """Two ranks' locality sweeps (boundary rows gathered, the boundary
    gamma_hat reduce-scattered and added at the exported rows) against
    the JAX package's, n = 61 padded to 62, SWEEPS sweeps a boundary: the
    stacked rows of gamma and mphi, lambda and every boundary's heldout
    sums at 1e-4; lambda and the sums are bit for bit equal on both
    ranks."""
    name = f"loc-trace{n_batches}" + ("-bf16" if bf16 else "")
    res = [r[name] for r in loc_ranks]
    got = (torch.cat([r[0] for r in res])[:cases.N].numpy(),
           res[0][1].numpy(), res[0][2].numpy(),
           torch.cat([r[3] for r in res])[:cases.N].numpy())
    want = _jax_locality(n_batches, bf16)
    tol = BF16_TOL if bf16 else TOL
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **tol)
    assert got[2].shape == (n_batches, 6)
    assert torch.equal(res[0][1], res[1][1])
    assert torch.equal(res[0][2], res[1][2])


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    d = tmp_path_factory.mktemp("planted")
    return write_planted(str(d), 400, 4, 16, 2)


def _run(main, cwd, net, gt, label, flags):
    os.chdir(cwd)
    assert main(["-file", net, "-n", "400", "-k", "4", "-nmi", gt, "-seed",
                 "1", "-label", label, "-link-sampling", *flags]) == 0
    out = [p for p in cwd.iterdir()
           if p.name.startswith(f"n400-k4-{label}-seed1")]
    assert len(out) == 1, out
    return out[0]


def test_cli_mesh_locality_matches_jax(planted, tmp_path, monkeypatch):
    """`-mesh 2 -mesh-locality` through both CLIs: both permute the nodes
    by the same locality order, sample the same splits and stop at the
    same iteration; the heldout rows agree at 5e-4 and gamma at the JAX
    CLI's mesh tolerance. Both ranks hold the same node order, and their
    lambda bit for bit (gamma is row-sharded)."""
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    net, gt = planted
    reports = tmp_path / "ranks"
    reports.mkdir()
    flags = ["-mesh", "2", "-mesh-locality"]
    out = {}
    for name, main in (
            ("jax", jax_main),
            ("torch", lambda argv: mesh.launch(argv, 2,
                                               report_dir=str(reports)))):
        (tmp_path / name).mkdir()
        out[name] = _run(main, tmp_path / name, net, gt, name, flags)
    ranks = [json.loads((reports / f"rank{r}.json").read_text())
             for r in range(2)]
    assert ranks[0]["order_sha256"] == ranks[1]["order_sha256"]
    assert ranks[0]["lam_sha256"] == ranks[1]["lam_sha256"]
    hj, ht = (np.loadtxt(out[k] / "heldout.txt") for k in ("jax", "torch"))
    assert ht.shape == hj.shape
    np.testing.assert_array_equal(ht[:, 0], hj[:, 0])
    np.testing.assert_allclose(ht[:, 2:], hj[:, 2:], **HELDOUT_TOL)
    gj, gt_ = (np.loadtxt(out[k] / "gamma.txt") for k in ("jax", "torch"))
    np.testing.assert_array_equal(gt_[:, :2], gj[:, :2])
    np.testing.assert_allclose(gt_[:, 2:], gj[:, 2:], **GAMMA_TOL)
    mj, mt = (open(out[k] / "max.txt").read().split()
              for k in ("jax", "torch"))
    assert mt[0] == mj[0], (mt, mj)
    params = open(out["torch"] / "param.txt").read()
    assert "locality internal frac" in params
    assert sorted(os.listdir(out["torch"])) == sorted(os.listdir(out["jax"]))


def test_one_rank_locality_is_the_rowshard_run(planted, tmp_path):
    """At one rank the locality layout has no boundary: the engine's
    -mesh-locality state equals -mesh 1 -mesh-rowshard -fuse-s3 on the
    same node order bit for bit, 12 sweeps in (one gloo rank in this
    process)."""
    net, _ = planted
    g = mesh.init_group(0, 1, "cpu", "gloo")
    try:
        state = {}
        for label, loc in (("rs", False), ("loc", True)):
            cfg = Config(n=400, k=4, link_sampling=True, seed=1,
                         fuse_s3=True, outdir=str(tmp_path / label),
                         max_iterations=12, use_validation_stop=False,
                         reportfreq=4, mesh_devices=1, mesh_rowshard=True,
                         mesh_locality=loc)
            cfg.resolve()
            nw = Network(cfg)
            nw.read(net)
            nw.drop_singles()
            nw.reorder_locality(1)
            eng = LinkSampling(cfg, nw, torch.device("cpu"), g)
            assert eng._locality == loc
            try:
                eng.infer()
            finally:
                eng.close()
            state[label] = (eng.gamma.clone(), eng.lam.clone(),
                            eng.mphi.clone())
        for a, b in zip(state["loc"], state["rs"]):
            assert torch.equal(a, b)
        hl, hr = (np.loadtxt(tmp_path / k / "heldout.txt")
                  for k in ("loc", "rs"))
        np.testing.assert_array_equal(np.delete(hl, 1, 1),
                                      np.delete(hr, 1, 1))
    finally:
        mesh.shutdown()


_ORDER = """
import hashlib, sys
sys.path.insert(0, {repo!r})
from svinet_torch.cli import parse_args
from svinet_torch.graph import Network
cfg = parse_args(["-file", {net!r}, "-n", "400", "-k", "4",
                  "-link-sampling"])
nw = Network(cfg)
nw.read(cfg.datfname)
nw.drop_singles()
nw.reorder_locality({d})
print(hashlib.sha256(nw.seq2id.tobytes() + nw.edges.tobytes()).hexdigest())
"""


@pytest.mark.parametrize("d", [2, 3])
def test_reorder_is_the_same_in_every_process(planted, d):
    """Every rank computes the locality order itself: three processes
    with different hash seeds get the same node order and links."""
    net, _ = planted
    digests = set()
    for seed in ("0", "1", "random"):
        env = dict(os.environ, PYTHONHASHSEED=seed)
        proc = subprocess.run(
            [sys.executable, "-c", _ORDER.format(repo=REPO, net=net, d=d)],
            env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        digests.add(proc.stdout.split()[-1])
    assert len(digests) == 1


def test_locality_without_link_sampling_is_refused(planted, tmp_path,
                                                   monkeypatch):
    """-mesh-locality names the link-sampling sweep, with the JAX
    message."""
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    net, _ = planted
    argv = ["-file", net, "-n", "400", "-k", "4", "-mesh-locality"]
    from svinet_torch.cli import main as torch_main
    for main in (torch_main, jax_main):
        with pytest.raises(SystemExit,
                           match="-mesh-locality requires -link-sampling"):
            main(argv)
