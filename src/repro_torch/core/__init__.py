"""Framework-neutral core of the port: strategy trees, classifier,
absorption fit, quality policy, controller and campaign store (in both its
layouts: one JSONL file, or append-only segments with a manifest).

The campaign store's public names are exported here, as the reference's
``repro.core`` exports them; they load on first use, so importing one
submodule (or running ``python -m repro_torch.core.campaign``) does not
import the campaign engine first.
"""
import importlib

_EXPORTS = {
    "repro_torch.core.campaign": (
        "AnalyticCampaign", "Campaign", "CampaignStats", "CampaignStore",
        "CampaignStoreError", "CompactStats", "MergeStats", "PairStatus",
        "compact_store", "host_store", "merge_stores", "read_store_records",
        "worker_store"),
    "repro_torch.core.segments": (
        "SegmentStore", "io_tally", "is_segmented", "manifest_status",
        "remove_store", "segments_dir", "store_exists"),
}
_HOME = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_HOME)


def __getattr__(name: str):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_HOME[name]), name)
