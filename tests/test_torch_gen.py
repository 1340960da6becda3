"""svinet_torch's generator family (-gen, -ppc, -gml, -lcstats) against
the JAX package's, on the CPU.

Wherever the draws are numpy's (pi, beta, ppc's per-draw pi and beta, the
sparse generator) and wherever no draw is made (gml, lcstats), the files
are the JAX package's byte for byte. The dense pair draw is kernel 16's
Philox4x32-10 stream, which JAX's threefry cannot give: there the port
draws from the same distribution, not the same edges, and the tests hold
its edges to the model (row-major pairs i < j, the edge count within 4
sigma of its exact expectation) and its uniforms to a chi-squared test."""

import os

import numpy as np
import pytest
import torch

from svinet_tpu.cli import main as jax_main
from svinet_torch.cli import main as torch_main
from svinet_torch.svi import gen as tgen
from svinet_torch.synth import write_planted

N, K = 60, 3


class _SparseN(int):
    """A node count that compares above the dense generator's 65,536
    limit (and equal to itself everywhere else), so that both packages'
    MMSBGen.gen take the sparse branch at a small n."""

    def __gt__(self, other):
        return other == 65536 or int(self) > other


def _run_both(tmp_path, monkeypatch, argv):
    """Both CLIs on argv, each in its own directory; returns the two run
    directories, JAX's first."""
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    dirs = []
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        monkeypatch.chdir(d)
        assert main(list(argv)) == 0
        dirs.append(d)
    return dirs


def _only_dir(d):
    (sub,) = [p for p in d.iterdir() if p.is_dir()]
    return sub


def _expected_links(pi, beta, eps):
    """The exact expectation and variance of the dense draw's edge count
    in float64."""
    s = pi @ (pi * beta).T          # sum_k pi_ik pi_jk beta_k
    same = pi @ pi.T                # sum_k pi_ik pi_jk
    p = s + eps * (1.0 - same)
    iu = np.triu_indices(len(pi), 1)
    return p[iu].sum(), (p[iu] * (1.0 - p[iu])).sum()


@pytest.mark.parametrize("extra", [[], ["-orig"], ["-disjoint"]],
                         ids=["gen", "gen_orig", "gen_disjoint"])
def test_gen_files_match_jax(tmp_path, monkeypatch, extra):
    """pi-gen.txt, beta-gen.txt, groups.txt, summary.txt (and
    beta-gen-matrix.txt under -orig) byte for byte; network_gen.dat holds
    pairs i < j in row-major order, as many as the model says within 4
    sigma."""
    argv = ["-n", "150", "-k", "4", "-gen", "-seed", "11", *extra]
    jd, td = (_only_dir(d) for d in _run_both(tmp_path, monkeypatch, argv))
    names = ["pi-gen.txt", "beta-gen.txt", "groups.txt", "summary.txt"]
    if extra == ["-orig"]:
        names.append("beta-gen-matrix.txt")
    for name in names:
        assert (td / name).read_bytes() == (jd / name).read_bytes(), name
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    edges = np.loadtxt(td / "network_gen.dat", dtype=np.int64, ndmin=2)
    assert (edges[:, 0] < edges[:, 1]).all()
    keys = edges[:, 0] * 150 + edges[:, 1]
    assert (np.diff(keys) > 0).all()
    # the model's pi and beta, drawn as both engines draw them
    rng = np.random.default_rng(11)
    alpha = 0.25 if extra == ["-orig"] else 0.05
    pi = rng.dirichlet(np.full(4, alpha), size=150)
    from svinet_torch.config import Config
    cfg = Config()
    beta = rng.beta(cfg.eta0_gen, cfg.eta1_gen, size=4)
    if extra == ["-disjoint"]:
        pi = 0.999 * np.eye(4)[pi.argmax(1)] + 0.001 / 4
    mean, var = _expected_links(pi, beta, cfg.epsilon)
    assert abs(len(edges) - mean) <= 4 * np.sqrt(var) + 1e-9, (
        len(edges), mean, var)


def test_philox_known_answers():
    """Philox4x32-10's published test vectors (Random123's kat_vectors)."""
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
             ((0xffffffff,) * 4, (0xffffffff,) * 2,
              (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
             ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
              (0xa4093822, 0x299f31d0),
              (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in cases:
        got = tgen.philox4x32(*(torch.tensor([c], dtype=torch.int64)
                                for c in ctr), *key)
        assert tuple(int(g[0]) for g in got) == want


def test_philox_uniforms_pass_chi_squared():
    """Each of the three uniforms of 200,000 pairs in 64 equal bins: the
    chi-squared statistic (63 degrees of freedom) below its 0.999
    quantile, 103.4; every value in [0, 1) and a multiple of 2^-24."""
    n = 632
    iu = torch.triu_indices(n, n, 1)
    i, j = iu[0][:200_000], iu[1][:200_000]
    for u in tgen.pair_uniforms(i, j, 123456789, 0):
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
        assert torch.equal(u * 2 ** 24, torch.floor(u * 2 ** 24))
        counts = torch.bincount((u * 64).long(), minlength=64).double()
        expect = u.shape[0] / 64
        chi2 = float(((counts - expect) ** 2 / expect).sum())
        assert chi2 < 103.4, chi2


def test_plain_draw_is_row_range_consistent():
    """The plain draw over rows [a, b) is the whole draw's rows [a, b):
    a pair's draw depends on the pair alone."""
    rng = np.random.default_rng(3)
    pi = rng.dirichlet(np.full(5, 0.3), size=90)
    cum = torch.as_tensor(tgen.cumulative_pi(pi))
    beta = torch.full((5,), 0.6)
    whole = tgen.gen_pairs_plain(cum, beta, 1e-3, 7, 2)
    part = tgen.gen_pairs_plain(cum, beta, 1e-3, 7, 2, 20, 47)
    sel = (whole[:, 0] >= 20) & (whole[:, 0] < 47)
    assert torch.equal(part, whole[sel]) and part.shape[0] > 0


def test_sparse_draw_matches_jax():
    """draw_network_sparse on the same numpy seed and (pi, beta) gives the
    JAX package's edges."""
    from svinet_tpu.svi.gen import draw_network_sparse as jsparse
    rng = np.random.default_rng(8)
    pi = rng.dirichlet(np.full(6, 0.1), size=3000)
    beta = rng.uniform(1e-4, 5e-4, size=6)
    a = jsparse(np.random.default_rng(9), pi, beta, 1e-30)
    b = tgen.draw_network_sparse(np.random.default_rng(9), pi, beta, 1e-30)
    assert a.shape[0] > 100
    np.testing.assert_array_equal(a, b)


def test_gen_takes_the_sparse_branch_as_jax(tmp_path, monkeypatch):
    """With n compared above 65,536 in both packages, -gen writes the
    sparse draw: every file byte for byte the JAX package's, the edges
    too."""
    import svinet_tpu.svi.gen as jgen
    for mod in (jgen, tgen):
        init = mod.MMSBGen.__init__

        def patched(self, *a, _init=init, **kw):
            _init(self, *a, **kw)
            self.n = _SparseN(self.n)

        monkeypatch.setattr(mod.MMSBGen, "__init__", patched)
    argv = ["-n", "400", "-k", "3", "-gen", "-seed", "4"]
    jd, td = (_only_dir(d) for d in _run_both(tmp_path, monkeypatch, argv))
    for name in sorted(os.listdir(jd)):
        assert (td / name).read_bytes() == (jd / name).read_bytes(), name
    assert (td / "network_gen.dat").stat().st_size > 0


@pytest.fixture
def model_dir(tmp_path):
    """A planted n=60 graph and a gamma.txt/lambda.txt for it."""
    d = tmp_path / "model"
    d.mkdir()
    net, _ = write_planted(str(d), N, K, 8, 1)
    rng = np.random.default_rng(6)
    gamma = rng.gamma(0.5, 4.0, size=(N, K)) + 0.01
    lam = rng.uniform(0.5, 20.0, size=(K, 2))
    with open(d / "gamma.txt", "w") as f:
        for i in range(N):
            f.write(f"{i}\t{i}\t" + "\t".join(f"{v:.5f}" for v in gamma[i])
                    + "\n")
    with open(d / "lambda.txt", "w") as f:
        for k in range(K):
            f.write(f"{k}\t{lam[k, 0]:.5f}\t{lam[k, 1]:.5f}\n")
    return d, net


def _with_model(tmp_path, model):
    for name in ("jax", "torch"):
        d = tmp_path / name
        d.mkdir()
        for f in ("gamma.txt", "lambda.txt"):
            (d / f).write_bytes((model / f).read_bytes())


@pytest.mark.parametrize("flag,names", [
    ("-gml", ["network.gml", "uncolored-links.txt", "node_bridgeness.txt",
              "node_influence.txt"]),
    ("-lcstats", ["community_stats.txt"])], ids=["gml", "lcstats"])
def test_gml_and_lcstats_match_jax(tmp_path, monkeypatch, model_dir, flag,
                                   names):
    """Every file byte for byte on the same gamma.txt and lambda.txt."""
    model, net = model_dir
    _with_model(tmp_path, model)
    argv = ["-file", net, "-n", str(N), "-k", str(K), flag]
    jd, td = (_only_dir(d) for d in _run_both(tmp_path, monkeypatch, argv))
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    for name in names:
        assert (td / name).read_bytes() == (jd / name).read_bytes(), name


def test_ppc_matches_jax(tmp_path, monkeypatch, model_dir):
    """-ppc at n=60: obs-*.txt byte for byte; ppc/*.txt with 100 rows (K
    for the link-community z-scores), every value finite."""
    model, net = model_dir
    _with_model(tmp_path, model)
    argv = ["-file", net, "-n", str(N), "-k", str(K), "-ppc", "-seed", "5"]
    jd, td = _run_both(tmp_path, monkeypatch, argv)
    obs = sorted(p.name for p in jd.iterdir() if p.name.startswith("obs-"))
    assert len(obs) == 4
    for name in obs:
        assert (td / name).read_bytes() == (jd / name).read_bytes(), name
    ppc = sorted(os.listdir(jd / "ppc"))
    assert sorted(os.listdir(td / "ppc")) == ppc
    for name in ppc:
        rows = [line.split() for line in open(td / "ppc" / name)]
        want = {"zscores.txt": 4, "lc_zscores_pe.txt": K,
                "lc_zscores_size.txt": K}.get(name, 100)
        assert len(rows) == want, name
        assert np.isfinite([float(r[-1]) for r in rows]).all(), name


@pytest.mark.parametrize("argv", [
    ["-n", "80", "-k", "3", "-gen", "-mesh", "2"],
    ["-k", str(K), "-gml", "-link-sampling", "-mesh", "2"]],
    ids=["gen_mesh2", "gml_linksampling_mesh2"])
def test_generator_family_under_mesh_runs_one_process(tmp_path, monkeypatch,
                                                      model_dir, argv):
    """-gen and -gml never read -mesh and win over -link-sampling: one
    process, as the JAX CLI runs them."""
    from svinet_torch.parallel import mesh

    def refuse(*a, **kw):
        raise AssertionError("went to the mesh launcher")

    model, net = model_dir
    monkeypatch.setattr(mesh, "launch", refuse)
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(model)
    if "-gml" in argv:
        argv = ["-file", net, "-n", str(N), *argv]
    assert torch_main(argv) == 0
    made = [p for p in model.iterdir() if p.is_dir()]
    want = "network_gen.dat" if "-gen" in argv else "network.gml"
    assert len(made) == 1 and (made[0] / want).exists()
