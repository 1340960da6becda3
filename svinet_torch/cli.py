"""svinet-compatible command line for the port.

    python -m svinet_torch -file net.txt -n 1000 -k 28 -link-sampling

Flags are parsed by svinet_tpu.cli.parse_args, so they mean what they mean
there; the network set-up is that of svinet_tpu/cli.py:314-319. The port
runs single-device -link-sampling. Every flag outside that slice stops the
run with SystemExit naming the flag; none is ignored. The device comes
from $SVINET_TORCH_DEVICE (default cuda).
"""

from __future__ import annotations

import signal
import sys
from typing import List, Optional

from svinet_tpu.cli import USAGE, parse_args
from svinet_tpu.config import Config
from svinet_tpu.graph import Network
from svinet_torch import resolve_device

# Config field -> the flag that sets it, for flags the port refuses
_ENGINE_FLAGS = (
    ("gen", "-gen"), ("ppc", "-ppc"), ("lcstats", "-lcstats"),
    ("gml", "-gml"), ("findk", "-findk"), ("orig", "-orig"),
    ("single", "-single"), ("batch", "-batch"),
    ("preprocess", "-preprocess"), ("informative_sampling", "-infset"),
    ("stratified", "-stratified"), ("randomnode", "-rnode"),
    ("randompair", "-rpair"),
)
_UNPORTED_FLAGS = (
    ("fuse_s3", "-fuse-s3"), ("bf16_rows", "-bf16"),
    ("freeze_converged", "-freeze"), ("prune", "-prune"),
    ("sparse_w", "-sparse-w"), ("mesh_devices", "-mesh"),
    ("mesh_rowshard", "-mesh-rowshard"), ("mesh_locality", "-mesh-locality"),
    ("dist_coordinator", "-dist-coordinator"),
    ("dist_nprocs", "-dist-nprocs"), ("dist_procid", "-dist-procid"),
    ("checkpoint_freq", "-checkpoint-freq"), ("resume", "-resume"),
    ("use_init_communities", "-init-communities"),
    ("load_test_sets", "-load-test-sets"), ("profile_dir", "-profile"),
)


def check_slice(cfg: Config) -> None:
    """Raise SystemExit naming the first flag the port does not run."""
    for field, flag in _ENGINE_FLAGS:
        if getattr(cfg, field):
            raise SystemExit(f"svinet_torch: {flag} is not ported; "
                             f"only -link-sampling runs")
    if not cfg.link_sampling:
        raise SystemExit("svinet_torch: only -link-sampling is ported; "
                         "pass -link-sampling")
    for field, flag in _UNPORTED_FLAGS:
        if getattr(cfg, field):
            raise SystemExit(f"svinet_torch: {flag} is not ported")
    if cfg.report_batch > 1:
        raise SystemExit("svinet_torch: -report-batch > 1 is not ported")


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(USAGE)
        return -1
    cfg = parse_args(argv)
    check_slice(cfg)
    device = resolve_device()

    network = Network(cfg)
    network.read(cfg.datfname)
    print(f"+ network: n = {network.n}, ones = {network.ones}, "
          f"singles = {network.singles}")
    # engines run on the observed nodes only (reference: src/main.cc:291)
    network.drop_singles()
    if cfg.groups_file:
        network.load_gt_groups(cfg.groups_file)

    from svinet_torch.svi.linksampling import LinkSampling
    engine = LinkSampling(cfg, network, device)

    # SIGTERM only sets a flag; the engine saves the model files at the
    # next report boundary and keeps running (reference: src/main.cc:29-46)
    def _term(_sig, _frm):
        engine.terminate_requested = True

    previous = signal.signal(signal.SIGTERM, _term)
    try:
        engine.infer()
    finally:
        signal.signal(signal.SIGTERM, previous)
        engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
