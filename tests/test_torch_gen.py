"""svinet_torch's generator family (-gen, -ppc, -gml, -lcstats) against
the JAX package's, on the CPU.

Wherever the draws are numpy's (pi, beta, ppc's per-draw pi and beta, the
sparse generator) and wherever no draw is made (gml, lcstats), the files
are the JAX package's byte for byte. The dense pair draw is kernel 16's
plain version on JAX's threefry stream (ops/threefry.py): its edges are
the JAX package's but at Gumbel near-ties, where the frameworks' logs may
order two of a pair's category scores otherwise. The tests count such
pairs (JAX's two best scores within NEAR_TIE) and allow no other
difference."""

import os

import jax
import numpy as np
import pytest
import torch

from svinet_tpu.cli import main as jax_main
from svinet_torch.cli import main as torch_main
from svinet_torch.svi import gen as tgen
from svinet_torch.synth import write_planted

N, K = 60, 3
# a pair's edge may differ from JAX's only where JAX's two best Gumbel
# scores of its z_p or z_q lie within this of each other
NEAR_TIE = 4e-6


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
    want = np.loadtxt(jd / "network_gen.dat", dtype=np.int64, ndmin=2)
    assert (edges[:, 0] < edges[:, 1]).all()
    keys = edges[:, 0] * 150 + edges[:, 1]
    assert (np.diff(keys) > 0).all()
    # the model's pi, drawn as both engines draw it
    rng = np.random.default_rng(11)
    alpha = 0.25 if extra == ["-orig"] else 0.05
    pi = rng.dirichlet(np.full(4, alpha), size=150)
    if extra == ["-disjoint"]:
        pi = 0.999 * np.eye(4)[pi.argmax(1)] + 0.001 / 4
    ties = _apart_at_near_ties(edges, want, pi, jax.random.PRNGKey(11))
    if ties == 0:
        assert (td / "network_gen.dat").read_bytes() == \
            (jd / "network_gen.dat").read_bytes()
    assert len(want) > 100


def _jax_scores(key, pi):
    """JAX's category scores of draw_network's one row block (n rows):
    gumbel(k1 or k2, (n, n, K)) + log(max(pi, 1e-300)) of row i (z_p) or
    row j (z_q), as _gen_rows forms them."""
    n, k = pi.shape
    logpi = np.log(np.maximum(pi, 1e-300)).astype(np.float32)
    k1, k2, _ = jax.random.split(jax.random.fold_in(key, 0), 3)
    gp = np.asarray(jax.random.gumbel(k1, (n, n, k)))
    gq = np.asarray(jax.random.gumbel(k2, (n, n, k)))
    return gp + logpi[:, None, :], gq + logpi[None, :, :]


def _gap(scores):
    """The best score less the second best, along the last axis."""
    top = np.sort(scores, axis=-1)
    return top[..., -1] - top[..., -2]


def _apart_at_near_ties(got, want, pi, key):
    """The pairs in one edge list and not the other, each of which must
    sit at a JAX near-tie (NEAR_TIE) of its z_p or z_q; returns their
    count. The draw is one row block (n K below 2^24)."""
    from svinet_torch.svi.gen import default_row_block
    n, k = pi.shape
    assert default_row_block(n, k) == n
    a = {tuple(e) for e in np.asarray(got).tolist()}
    b = {tuple(e) for e in np.asarray(want).tolist()}
    apart = sorted(a ^ b)
    if apart:
        sp, sq = _jax_scores(key, pi)
        gp, gq = _gap(sp), _gap(sq)
        far = [(i, j) for i, j in apart
               if min(gp[i, j], gq[i, j]) > NEAR_TIE]
        assert not far, far
    return len(apart)


def test_draw_network_matches_jax_edges():
    """Kernel 16's plain version on JAX's stream writes the JAX package's
    edges, under -gen's beta (near 1, so nearly every pair draws both
    categories) and a low beta with eps above zero (the u-first shortcut's
    cases), at two seeds."""
    from svinet_tpu.svi.gen import draw_network as jdraw
    from svinet_torch.ops import threefry
    rng = np.random.default_rng(5)
    pi = rng.dirichlet(np.full(5, 0.3), size=120)
    for seed, beta, eps in ((11, rng.beta(4700.59, 0.77, size=5), 1e-30),
                            (2**31 + 7, rng.uniform(0.05, 0.3, 5), 0.02)):
        key = jax.random.PRNGKey(seed)
        want = jdraw(key, pi, beta, eps)
        got = tgen.draw_network(pi, beta, eps, threefry.prng_key(seed),
                                torch.device("cpu"))
        assert _apart_at_near_ties(got, want, pi, key) == 0
        np.testing.assert_array_equal(got, want)
        assert len(want) > 100


def test_plain_draw_is_row_range_consistent():
    """The plain draw over rows [a, b) is the whole draw's rows [a, b):
    a pair's draw depends on the pair and its row block alone."""
    from svinet_torch.ops import threefry
    rng = np.random.default_rng(3)
    pi = rng.dirichlet(np.full(5, 0.3), size=90)
    logits = torch.as_tensor(tgen.logits_of(pi))
    beta = torch.full((5,), 0.6)
    key = threefry.fold_in(threefry.prng_key(7), 2)
    # row blocks of 16: the range [20, 47) crosses two block keys
    whole = tgen.gen_pairs_plain(logits, beta, 1e-3, key, 16)
    part = tgen.gen_pairs_plain(logits, beta, 1e-3, key, 16, 20, 47)
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
    """-ppc at n=60: obs-*.txt byte for byte; each of the 100 draws' edges
    the JAX package's but at counted Gumbel near-ties; ppc/*.txt with 100
    rows (K for the link-community z-scores), every value finite, and
    byte for byte JAX's where no draw was apart."""
    import svinet_tpu.svi.gen as jgen
    model, net = model_dir
    _with_model(tmp_path, model)
    drawn = {"jax": [], "torch": []}

    def keep(mod, name, key_at, pi_at):
        inner = mod.draw_network

        def wrapped(*a, **kw):
            edges = inner(*a, **kw)
            drawn[name].append((a[key_at], np.array(a[pi_at]),
                                np.asarray(edges)))
            return edges
        monkeypatch.setattr(mod, "draw_network", wrapped)

    keep(jgen, "jax", 0, 1)
    keep(tgen, "torch", 3, 0)
    argv = ["-file", net, "-n", str(N), "-k", str(K), "-ppc", "-seed", "5"]
    jd, td = _run_both(tmp_path, monkeypatch, argv)
    assert len(drawn["jax"]) == len(drawn["torch"]) == 100
    apart = 0
    for d, ((jkey, jpi, want), (tkey, tpi, got)) in enumerate(
            zip(drawn["jax"], drawn["torch"])):
        np.testing.assert_array_equal(jpi, tpi)
        assert tuple(np.asarray(jkey).tolist()) == tkey, d
        apart += _apart_at_near_ties(got, want, jpi, jkey)
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
        if apart == 0 and not name.startswith("lc_"):
            assert (td / "ppc" / name).read_bytes() == \
                (jd / "ppc" / name).read_bytes(), name


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
