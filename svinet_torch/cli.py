"""svinet-compatible command line for the port.

    python -m svinet_torch -file net.txt -n 1000 -k 28 -link-sampling

USAGE and parse_args are the port's own copy of svinet_tpu/cli.py:21-278
(every flag parses to the same Config there and here; the tests hold the
two equal); the network set-up is that of svinet_tpu/cli.py:314-333. The
port runs every engine of the JAX CLI, in its dispatch order: the
generator (-gen, before the network is read), -ppc, -lcstats and -gml,
FastInit (-findk), the full blockmodel (-orig), -link-sampling, SBM
(-single, batch and -infset), MMSBInfer, FastAMM (-infset) and FastAMM2
(-stratified -rnode), on one device or, for -link-sampling, MMSBInfer and
FastAMM2, under -mesh N (-mesh-rowshard and -mesh-locality for
-link-sampling), where the CLI spawns N ranks (parallel/mesh.py:launch),
or N/P of them in each of the P processes of -dist-nprocs P. The device
comes from $SVINET_TORCH_DEVICE (default cuda).
"""

from __future__ import annotations

import shutil
import signal
import sys
import tempfile
from typing import List, Optional

from svinet_torch import resolve_device
from svinet_torch.config import Config
from svinet_torch.graph import Network
from svinet_torch.parallel import mesh

USAGE = """\
SVINET-TORCH: stochastic variational inference of undirected networks (PyTorch/CUDA)
svinet [OPTIONS]
\t-help\t\tusage
\t-file <name>\tinput tab-separated file with a list of undirected links
\t-n <N>\t\tnumber of nodes in network
\t-k <K>\t\tnumber of communities
\t-batch\t\trun batch variational inference
\t-stratified\tuse stratified sampling (with -rpair or -rnode)
\t-rnode\t\tinference using random node sampling
\t-rpair\t\tinference using random pair sampling
\t-link-sampling\tinference using link sampling
\t-infset\t\tinference using informative set sampling
\t-preprocess\tpreprocess to run informative set sampling
\t-findk\t\testimate the number of communities
\t-single\t\tstochastic blockmodel inference
\t-orig\t\tfull-blockmodel (Airoldi et al.) batch inference
\t-itype <0|1>\torig beta init: 0 random, 1 data-derived assortative
\t-gen\t\tgenerate a network from the model
\t-ppc\t\tposterior predictive checks
\t-gml\t\tgenerate a GML visualization of link communities
\t-nmi <file>\tground-truth communities file; logs NMI per report
\t-rfreq <R>\treport/convergence frequency in iterations
\t-report-batch <B>\tfuse B report boundaries per device dispatch
\t\t(link-sampling; exact per-boundary heldout rows, stop/anneal
\t\tdecisions land up to B-1 sweeps late)
\t-max-iterations <M>\tmaximum iterations (use with -no-stop)
\t-no-stop\tdisable stopping criteria
\t-seed <S>\trandom seed
\t-eta-type <t>\tuniform | fromdata | sparse | dense
\t-heldout-ratio <r>\tfraction of links held out
\t-label <s>\ttag output directory
\t-mesh <N>\tshard the link-sampling sweep across N devices
\t-mesh-rowshard\talso shard gamma rows (for n*K beyond one chip's HBM)
\t-mesh-locality\tnode-locality partition: boundary-rows-only collectives
\t\t(implies -mesh-rowshard -fuse-s3)
\t-sparse-w <W>\ttop-W union sweep for link-sampling at huge K
\t-dist-coordinator <host:port>\tmulti-host coordinator address
\t-dist-nprocs <N>\tnumber of hosts (launch one process per host)
\t-dist-procid <I>\tthis host's process index
\t-freeze\t\tfreeze converged nodes (consolidates overshot K)
\t-fuse-s3\tfold the s3 cross-moment into the phi pass (1-sweep lag)
\t-bf16\tstore gathered sweep rows in bfloat16 (f32 accumulation)
\t-prune\tenable active-K column compaction after annealing (default off)
\t-no-force\trefuse to overwrite an existing non-empty output dir
\t-prune-frac F\tcompact when padded active width <= F*K (default 0.5)
\t-fastqueue <W>\tsparse top-W gamma for -infset at huge K
\t-findk-width <W>\toverride -findk's sparse label slots per node
\t-anneal-drawdown <d>\tannealing-exit drawdown threshold (default 0.08)
\t-anneal-plateau-rate <r>\tannealing-exit plateau rate (default 1e-6)
\t-anneal-decline-sweeps <s>\tsustained-decline annealing exit (default 24)
"""


def parse_args(argv: List[str]) -> Config:
    cfg = Config()
    rfreq_set = False
    i = 0
    while i < len(argv):
        a = argv[i]

        def nxt() -> str:
            nonlocal i
            i += 1
            if i >= len(argv):
                print("+ insufficient arguments!", file=sys.stderr)
                sys.exit(-1)
            return argv[i]

        if a == "-help":
            print(USAGE)
            sys.exit(0)
        elif a == "-file":
            cfg.datfname = nxt()
        elif a == "-n":
            cfg.n = int(nxt())
        elif a == "-k":
            cfg.k = int(nxt())
        elif a == "-link-sampling":
            cfg.link_sampling = True
        elif a == "-batch":
            cfg.batch = True
            cfg.reportfreq = 1
            rfreq_set = True
        elif a == "-stratified":
            cfg.stratified = True
        elif a == "-rnode":
            cfg.randomnode = True
        elif a == "-rpair":
            cfg.randompair = True
        elif a == "-findk":
            cfg.findk = True
        elif a == "-single":
            cfg.single = True
            # the reference couples -single with random zero sets: its
            # neighborhood preprocessing for SBM uses RANDOM zeros, not
            # the 2-hop informative walk (src/main.cc:191-193)
            cfg.randzeros = True
        elif a == "-orig":
            cfg.orig = True
        elif a == "-itype":
            cfg.itype = int(nxt())
        elif a == "-mesh":
            cfg.mesh_devices = int(nxt())
        elif a == "-mesh-rowshard":
            cfg.mesh_rowshard = True
        elif a == "-mesh-locality":
            cfg.mesh_locality = True
        elif a == "-sparse-w":
            cfg.sparse_w = int(nxt())
        elif a == "-dist-coordinator":
            cfg.dist_coordinator = nxt()
        elif a == "-dist-nprocs":
            cfg.dist_nprocs = int(nxt())
        elif a == "-dist-procid":
            cfg.dist_procid = int(nxt())
        elif a == "-freeze":
            cfg.freeze_converged = True
        elif a == "-fuse-s3":
            cfg.fuse_s3 = True
        elif a == "-bf16":
            cfg.bf16_rows = True
        elif a == "-prune":
            cfg.prune = True
        elif a == "-no-prune":
            cfg.prune = False
        elif a == "-prune-frac":
            cfg.prune_frac = float(nxt())
        elif a == "-anneal-drawdown":
            cfg.anneal_drawdown = float(nxt())
        elif a == "-anneal-plateau-rate":
            cfg.anneal_plateau_rate = float(nxt())
        elif a == "-anneal-decline-sweeps":
            cfg.anneal_decline_sweeps = int(nxt())
        elif a == "-findk-width":
            cfg.findk_width = int(nxt())
        elif a == "-fastqueue":
            cfg.fastqueue_width = int(nxt())
        elif a == "-infset":
            cfg.informative_sampling = True
        elif a == "-preprocess":
            cfg.preprocess = True
            cfg.informative_sampling = True
        elif a == "-randzeros":
            cfg.randzeros = True
        elif a == "-gen":
            cfg.gen = True
        elif a == "-ppc":
            cfg.ppc = True
        elif a == "-lcstats":
            cfg.lcstats = True
        elif a == "-gml":
            cfg.gml = True
        elif a == "-nodelay":
            cfg.delaylearn = False
        elif a == "-nmi":
            cfg.ground_truth_fname = nxt()
            cfg.nmi = True
        elif a == "-rfreq":
            cfg.reportfreq = int(nxt())
            rfreq_set = True
        elif a == "-report-batch":
            cfg.report_batch = int(nxt())
        elif a == "-max-iterations":
            cfg.max_iterations = int(nxt())
        elif a == "-no-stop":
            cfg.use_validation_stop = False
        elif a == "-seed":
            cfg.seed = int(float(nxt()))
        elif a == "-eta-type":
            cfg.eta_type = nxt()
        elif a == "-heldout-ratio":
            cfg.heldout_ratio = float(nxt())
        elif a == "-alpha":
            cfg.alpha = float(nxt())
        elif a == "-checkpoint-freq":
            cfg.checkpoint_freq = float(nxt())
        elif a == "-resume":
            cfg.resume = True
        elif a == "-profile":
            cfg.profile_dir = nxt()
        elif a == "-label":
            cfg.label = nxt()
        elif a == "-load":
            cfg.model_load = True
            cfg.gamma_location = nxt()
        elif a == "-load-validation":
            cfg.load_heldout = True
            cfg.load_heldout_fname = nxt()
        elif a == "-load-test":
            cfg.load_test = True
            cfg.load_test_fname = nxt()
        elif a == "-stopthresh":
            cfg.stopthresh = float(nxt())
        elif a == "-inf":
            cfg.infthresh = float(nxt())
        elif a == "-nonuniform":
            # requires -inf <t>, checked after parsing (reference runs the
            # nonuniform sampler only under `if (_env.infthresh)`,
            # src/mmsbinfer.cc:543-548)
            cfg.nonuniform = True
        elif a == "-strid":
            cfg.strid = True
        elif a == "-groups-file":
            cfg.groups_file = nxt()
        elif a == "-logl":
            cfg.logl = True
        elif a == "-link-thresh":
            cfg.link_thresh = float(nxt())
        elif a == "-lt-min-deg":
            cfg.lt_min_deg = int(nxt())
        elif a == "-scale":
            cfg.subsample_scale = int(nxt())
        elif a == "-accuracy":
            cfg.accuracy = True
        elif a == "-init-communities":
            cfg.use_init_communities = True
            cfg.init_communities_fname = nxt()
        elif a == "-disjoint":
            cfg.disjoint = True
        elif a == "-load-test-sets":
            cfg.load_test_sets = True
        elif a == "-force":
            cfg.force_overwrite_dir = True
        elif a == "-no-force":
            cfg.force_overwrite_dir = False
        elif a == "-adamic-adar":
            # score the Adamic-Adar link-prediction baseline over the
            # precision sample and exit without inference (reference:
            # src/fastamm2.cc:131-134; FastAMM's copy is behind an
            # #ifdef PRECISION_SAMPLE that the shipped build omits)
            cfg.adamic_adar = True
        elif a in ("-online", "-gp", "-bmark"):
            pass  # accepted for compatibility
        elif a == "-nthreads":
            nxt()  # pthreads knob: no meaning here, accepted for compatibility
        else:
            print(f"+ unknown flag {a}", file=sys.stderr)
            sys.exit(-1)
        i += 1

    # reference bumps rfreq to 100 in sampled modes unless given
    if not rfreq_set and (cfg.randomnode or cfg.randompair or cfg.stratified):
        cfg.reportfreq = 100
    if cfg.adamic_adar and not (cfg.stratified and cfg.randomnode):
        # same as the reference: env.adamic_adar is only consulted by
        # FastAMM2 (src/fastamm2.cc:131-134; FastAMM's copy is compiled
        # out), so under any other engine the flag does nothing — warn
        # instead of silently running a full inference
        print("+ -adamic-adar only applies with -stratified -rnode; "
              "ignored for this engine (matching the reference)",
              file=sys.stderr)
    if cfg.nonuniform and cfg.infthresh <= 0:
        print("+ -nonuniform requires -inf <threshold>; it is a no-op "
              "without one (matching the reference dispatch, "
              "src/mmsbinfer.cc:543-548)", file=sys.stderr)
    cfg.resolve()
    return cfg


def main(argv: Optional[List[str]] = None, group=None) -> int:
    """The CLI on `argv`. `group` (parallel/mesh.py:Group) is given to a
    rank of a mesh, which runs the engine as that rank; without it a mesh
    run spawns its ranks."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(USAGE)
        return -1
    cfg = parse_args(argv)
    dist = mesh.Dist.of(cfg)
    if group is None and dist is not None:
        print(f"+ distributed: process {dist.procid} of {dist.nprocs}")
    if group is None and mesh.wants_mesh(cfg):
        # one rank a device, each running this CLI (parallel/mesh.py);
        # under -dist-nprocs this process's share of them
        return mesh.launch(argv, mesh.mesh_ranks(cfg), dist=dist)
    if cfg.gen:
        # the generator reads no network: dispatched first, after a
        # -dist-nprocs process other than 0 has its directory
        # (svinet_tpu/cli.py:287-312)
        if dist is not None:
            cfg.outdir = dist.outdir(cfg.outdir)
        from svinet_torch.svi.gen import MMSBGen
        MMSBGen(cfg, None, resolve_device()).gen()
        return 0

    # SIGTERM: before the engine exists the run ends with status 0; after,
    # it only sets a flag, and the engine saves the model files at the
    # next report boundary and keeps running (reference:
    # src/main.cc:29-46; svinet_tpu/cli.py:343-353)
    box = {}

    def _term(_sig, _frm):
        engine = box.get("engine")
        if engine is None:
            sys.exit(0)
        engine.terminate_requested = True

    previous = signal.signal(signal.SIGTERM, _term)
    private = None
    try:
        if group is not None and not group.primary:
            # a rank other than 0 writes its report rows apart: the first
            # rank of a process other than 0 into that process's directory
            # (outdir/proc<i>), the others into a private one; every rank
            # restores checkpoints from rank 0's directory
            cfg.ckpt_outdir = cfg.outdir
            if group.lead and dist is not None:
                cfg.outdir = dist.outdir(cfg.outdir)
            else:
                private = tempfile.mkdtemp(
                    prefix=f"svinet_torch_rank{group.rank}_")
                cfg.outdir = private
        elif group is None and dist is not None:
            # a process of a run without a mesh runs the engine by itself,
            # as each process of the JAX CLI does; one other than 0 writes
            # under outdir/proc<i>, its checkpoints too
            cfg.outdir = dist.outdir(cfg.outdir)
        engine, run = _build_engine(cfg, group)
        if engine is None:
            return 0
        box["engine"] = engine
        if group is not None:
            mesh.engine_ready(group, engine)
        try:
            run()
        finally:
            engine.close()
    finally:
        signal.signal(signal.SIGTERM, previous)
        if private is not None:
            shutil.rmtree(private, ignore_errors=True)
    return 0


def _build_engine(cfg: Config, group):
    """Read the network and build the engine the flags name, in the
    dispatch order of svinet_tpu/cli.py:355-418. Returns (engine, its
    loop), or (None, None) for -ppc, -lcstats and -gml, which run here on
    the model files in the cwd, and for -preprocess, which writes
    neighbors.bin on the host; none of these builds an engine."""
    network = Network(cfg)
    network.read(cfg.datfname)
    print(f"+ network: n = {network.n}, ones = {network.ones}, "
          f"singles = {network.singles}")
    # engines run on the observed nodes only (reference: src/main.cc:291)
    network.drop_singles()
    if cfg.mesh_locality:
        # the locality permutation of the seq ids, before any split is
        # sampled; every rank computes it from the same graph, and it is
        # deterministic (svinet_tpu/cli.py:320-333)
        if not cfg.link_sampling:
            raise SystemExit("-mesh-locality requires -link-sampling")
        cfg.mesh_devices = nd = mesh.mesh_ranks(cfg)
        if not cfg.fuse_s3:
            print("+ -mesh-locality implies -fuse-s3")
            cfg.fuse_s3 = True
        if not cfg.mesh_rowshard:
            print("+ -mesh-locality implies -mesh-rowshard")
            cfg.mesh_rowshard = True
        network.reorder_locality(nd)
    if cfg.groups_file:
        network.load_gt_groups(cfg.groups_file)
    device = resolve_device() if group is None else group.device
    if cfg.ppc or cfg.lcstats or cfg.gml:
        from svinet_torch.svi.gen import MMSBGen
        gen = MMSBGen(cfg, network, device)
        (gen.ppc if cfg.ppc else
         gen.get_lc_stats if cfg.lcstats else gen.gml)()
        return None, None
    if cfg.findk:
        from svinet_torch.svi.fastinit import FastInit
        engine = FastInit(cfg, network, device)
        return engine, engine.batch_infer
    if cfg.orig:
        from svinet_torch.svi.orig import MMSBOrig
        engine = MMSBOrig(cfg, network, device)
        return engine, engine.batch_infer
    if cfg.link_sampling:
        from svinet_torch.svi.linksampling import LinkSampling
        engine = LinkSampling(cfg, network, device, group)
        return engine, engine.infer
    if cfg.single:
        from svinet_torch.svi.sbm import SBM
        engine = SBM(cfg, network, device)
        return engine, (engine.infer if cfg.informative_sampling
                        else engine.batch_infer)
    if cfg.batch:
        from svinet_torch.svi.mmsb import MMSBInfer
        engine = MMSBInfer(cfg, network, device, group)
        return engine, engine.batch_infer
    if cfg.preprocess:
        network.set_neighborhood_sets(cfg)
        return None, None
    if cfg.informative_sampling:
        from svinet_torch.svi.fastamm import FastAMM
        engine = FastAMM(cfg, network, device)
        return engine, engine.infer
    if cfg.stratified and cfg.randomnode:
        from svinet_torch.svi.fastamm2 import FastAMM2
        engine = FastAMM2(cfg, network, device, group)
        return engine, engine.infer
    from svinet_torch.svi.mmsb import MMSBInfer
    engine = MMSBInfer(cfg, network, device, group)
    return engine, engine.infer


if __name__ == "__main__":
    sys.exit(main())
