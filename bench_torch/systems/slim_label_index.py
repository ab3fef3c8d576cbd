"""A client's local Slim index, as ``slim_index`` builds it, whose nodes
carry one u32 tag word each (``HnswSlimIndex.set_tags``) and whose queries
carry one need word each: ``search(queries, k, need)`` returns, for each
query, only nodes v with (tags[v] & need) == need (``search(need=)``)."""

from __future__ import annotations

from systems import slim_index


class SlimLabelIndexSystem(slim_index.SlimIndexSystem):
    def set_tags(self, tags) -> None:
        """Install the nodes' tag words u32[n] (on the card, once)."""
        self.index.set_tags(tags)

    def search(self, queries, k: int, need=None):
        """(d f32[B, k], ids i32[B, k]) as host arrays, each query filtered
        by its need word need[B] (u32)."""
        return self.index.search(queries, k, need=need)


def build(cfg: dict, data, device) -> SlimLabelIndexSystem:
    from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex

    # a port without per-query predicates cannot serve the configuration:
    # say so before the build, not after it
    if not hasattr(HnswSlimIndex, "set_tags"):
        raise RuntimeError("slim_label_index: this HnswSlimIndex has no "
                           "set_tags (per-query label predicates)")
    return SlimLabelIndexSystem(slim_index.build(cfg, data, device).index)
