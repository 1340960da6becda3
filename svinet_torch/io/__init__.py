from svinet_torch.io.writers import (
    save_model, load_model, write_communities, write_groups,
    ReportFile, write_max, write_edgelist,
)

__all__ = [
    "save_model", "load_model", "write_communities", "write_groups",
    "ReportFile", "write_max", "write_edgelist",
]
