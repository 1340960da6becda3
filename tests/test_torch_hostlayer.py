"""The port's own copies of the host layer against their originals.

svinet_torch imports nothing of svinet_tpu, so it carries copies of the
JAX-free host modules (config, graph, io.writers, io.native,
parallel.locality, svi.sampling, evals.precision, and the flag parser of
cli; and numpy functions of modules that import JAX, such as SBM's chunk
lists). Each copy is held to its original here, on the CPU:
same flags -> same Config, same file -> same Network and splits, same
arrays -> the same bytes on disk, and the module texts themselves may
differ only in the package name."""

import dataclasses
import filecmp
import importlib
import inspect
import pathlib

import numpy as np
import pytest

import svinet_tpu.cli as jcli
import svinet_tpu.config as jconfig
import svinet_tpu.graph as jgraph
import svinet_tpu.io as jio
import svinet_tpu.io.native as jnative
import svinet_tpu.io.writers as jwriters
import svinet_torch.cli as tcli
import svinet_torch.config as tconfig
import svinet_torch.graph as tgraph
import svinet_torch.io as tio
import svinet_torch.io.native as tnative
import svinet_torch.io.writers as twriters
from svinet_torch.synth import write_planted

REPO = pathlib.Path(__file__).resolve().parents[1]
BASE = ["-file", "net.txt", "-n", "120", "-k", "6"]

ARGVS = [
    [],
    ["-link-sampling"],
    ["-link-sampling", "-fuse-s3"],
    ["-link-sampling", "-report-batch", "4"],
    ["-link-sampling", "-bf16"],
    ["-link-sampling", "-freeze"],
    ["-link-sampling", "-prune", "-prune-frac", "0.25"],
    ["-link-sampling", "-sparse-w", "8"],
    ["-link-sampling", "-mesh", "2", "-mesh-rowshard"],
    ["-link-sampling", "-mesh-locality"],
    ["-link-sampling", "-dist-coordinator", "h:1", "-dist-nprocs", "2",
     "-dist-procid", "1"],
    ["-link-sampling", "-checkpoint-freq", "5", "-resume"],
    ["-link-sampling", "-init-communities", "c.txt"],
    ["-link-sampling", "-load-test-sets"],
    ["-link-sampling", "-profile", "p"],
    ["-batch"],
    ["-link-sampling", "-findk", "-findk-width", "3"],
    ["-stratified", "-rnode"],
    ["-rpair", "-rfreq", "7"],
    ["-single"],
    ["-infset", "-fastqueue", "4"],
    ["-link-sampling", "-nmi", "gt.txt", "-seed", "3", "-label", "x",
     "-max-iterations", "9", "-no-stop", "-lt-min-deg", "1"],
    ["-link-sampling", "-load", "dir", "-load-validation", "v.txt",
     "-heldout-ratio", "0.02", "-alpha", "0.1", "-eta-type", "fromdata"],
    ["-link-sampling", "-anneal-drawdown", "0.1", "-anneal-plateau-rate",
     "1e-5", "-anneal-decline-sweeps", "12", "-stopthresh", "1e-4"],
    ["-gen"], ["-ppc"], ["-gml"], ["-lcstats"], ["-orig", "-itype", "1"],
    ["-preprocess"], ["-strid", "-groups-file", "g.txt", "-no-force",
                      "-nthreads", "4", "-online"],
]


@pytest.mark.parametrize("flags", ARGVS, ids=lambda f: " ".join(f) or "defaults")
def test_parse_args_matches_original(flags):
    ours = tcli.parse_args(BASE + flags)
    theirs = jcli.parse_args(BASE + flags)
    assert type(ours) is tconfig.Config and type(theirs) is jconfig.Config
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.outdir == theirs.outdir


def test_usage_lists_the_same_flags():
    """Only the headline differs: the flag lines are the original's."""
    assert tcli.USAGE.splitlines()[1:] == jcli.USAGE.splitlines()[1:]
    with pytest.raises(SystemExit):
        tcli.parse_args(["-no-such-flag"])
    with pytest.raises(SystemExit):
        tcli.parse_args(["-n"])


def _network(mod_graph, mod_config, path, n, k):
    cfg = mod_config.Config(n=n, k=k, link_sampling=True)
    cfg.resolve()
    net = mod_graph.Network(cfg)
    net.read(path)
    net.drop_singles()
    net.sample_heldout_sets(np.random.default_rng(cfg.seed))
    net.assign_training_links()
    return net


@pytest.mark.parametrize("n,k,seed", [(200, 4, 5), (600, 6, 1)])
def test_network_matches_original(tmp_path, n, k, seed):
    path, _ = write_planted(str(tmp_path), n, k, 10, seed)
    ours = _network(tgraph, tconfig, path, n, k)
    theirs = _network(jgraph, jconfig, path, n, k)
    assert (ours.n, ours.ones, ours.singles) == (
        theirs.n, theirs.ones, theirs.singles)
    assert len(ours.training_links) and len(ours.validation_pairs)
    for name in ("edges", "training_links", "training_deg",
                 "validation_pairs", "validation_y", "seq2id", "deg"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ours.id2seq == theirs.id2seq


def test_writers_write_the_same_bytes(tmp_path):
    rng = np.random.default_rng(0)
    n, k = 50, 5
    gamma = rng.gamma(2.0, 2.0, size=(n, k)).astype(np.float32)
    lam = rng.uniform(0.5, 9.0, size=(k, 2)).astype(np.float32)
    seq2id = rng.permutation(n) + 1000
    comms = {2: [3, 1, 7], 0: [4, 5], 9: []}
    pairs = rng.integers(0, n, size=(12, 2)).astype(np.int32)
    ys = rng.integers(0, 2, size=12).astype(np.int8)
    dirs = {}
    for tag, mod, nat in (("ours", twriters, tnative),
                          ("theirs", jwriters, jnative)):
        d = tmp_path / tag
        d.mkdir()
        mod.save_model(str(d), gamma, lam, seq2id)
        mod.write_communities(str(d / "communities.txt"), comms, seq2id)
        mod.write_groups(str(d / "groups.txt"), gamma, seq2id)
        mod.write_max(str(d / "max.txt"), 7, 3, -0.1, -0.2, -0.3, 1)
        mod.write_edgelist(str(d / "pairs.txt"), pairs, ys, seq2id)
        nat.write_edges_tsv(str(d / "edges.txt"), seq2id[pairs])
        dirs[tag] = d
    names = sorted(p.name for p in dirs["ours"].iterdir())
    assert {"gamma.txt", "lambda.txt", "communities.txt", "groups.txt",
            "max.txt", "pairs.txt"} <= set(names)
    assert names == sorted(p.name for p in dirs["theirs"].iterdir())
    _, mismatch, errors = filecmp.cmpfiles(dirs["ours"], dirs["theirs"],
                                           names, shallow=False)
    assert not mismatch and not errors
    # and the files read back, through either package's loader
    g1, l1 = twriters.load_model(str(dirs["ours"]), n, k)
    g2, l2 = jwriters.load_model(str(dirs["theirs"]), n, k)
    np.testing.assert_array_equal(g1, g2)
    np.testing.assert_array_equal(l1, l2)
    # the text keeps 5 decimals
    np.testing.assert_allclose(g1, gamma, atol=5e-6, rtol=1.2e-7)
    np.testing.assert_allclose(l1, lam, atol=5e-6, rtol=1.2e-7)
    assert tnative.have_native() == jnative.have_native()


def test_io_package_exports():
    """The port's io exports what the original's does (it has no
    checkpoint module: that one needs JAX and orbax)."""
    assert sorted(tio.__all__) == sorted(jio.__all__)
    for name in tio.__all__:
        assert getattr(tio, name).__module__ == "svinet_torch.io.writers"


@pytest.mark.parametrize("rel", ["config.py", "graph.py", "io/writers.py",
                                 "io/native.py", "io/__init__.py",
                                 "parallel/locality.py", "svi/sampling.py",
                                 "evals/precision.py"])
def test_copies_have_not_drifted(rel):
    """A copy is its original with the package name replaced; a fix to one
    must be made in both."""
    original = (REPO / "svinet_tpu" / rel).read_text()
    copy = (REPO / "svinet_torch" / rel).read_text()
    assert copy == original.replace("svinet_tpu", "svinet_torch")


def test_parse_args_copy_has_not_drifted():
    """cli.parse_args is the original's text (main's engine dispatch is
    not copied: it imports the JAX engines)."""
    def body(text):
        start = text.index("def parse_args(")
        end = "    cfg.resolve()\n    return cfg\n"
        return text[start:text.index(end, start) + len(end)]
    original = body((REPO / "svinet_tpu" / "cli.py").read_text())
    copy = body((REPO / "svinet_torch" / "cli.py").read_text())
    assert copy.replace("no meaning here, accepted",
                        "N/A on TPU, accepted") == original


@pytest.mark.parametrize("module,name", [
    ("svi.sbm", "chunk_incident_pairs"),
    ("svi.gen", "draw_network_sparse"),
    ("svi.gen", "local_clustering_avg"),
    ("svi.gen", "bridgeness"),
])
def test_numpy_function_copies_have_not_drifted(module, name):
    """A numpy function copied whole out of a module that imports JAX is
    its original's text."""
    original = getattr(importlib.import_module(f"svinet_tpu.{module}"), name)
    copy = getattr(importlib.import_module(f"svinet_torch.{module}"), name)
    assert inspect.getsource(copy) == inspect.getsource(original)


def test_fastinit_and_sbm_engines_are_dispatched_as_the_original():
    """FastInit, then MMSBOrig, before LinkSampling, SBM after it and
    before MMSBInfer's batch engine, then FastAMM and FastAMM2: the two
    CLIs build the engines in the same order (svinet_tpu/cli.py:367-418)."""
    engines = ("FastInit(cfg", "MMSBOrig(cfg", "LinkSampling(cfg", "SBM(cfg",
               "MMSBInfer(cfg", "FastAMM(cfg", "FastAMM2(cfg")
    for path, start in (("svinet_tpu/cli.py", "def main("),
                        ("svinet_torch/cli.py", "def _build_engine(")):
        text = (REPO / path).read_text()
        text = text[text.index(start):]
        at = [text.index(e) for e in engines]
        assert at == sorted(at), (path, at)
