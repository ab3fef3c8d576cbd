"""The paper's server: ``SlimServer`` (the HNSW it builds, its Slim mirror
by ``IncrementalSlim.full``, both dense serving layouts, the 2 ms query
batcher) serving HTTP on 127.0.0.1 at a free port, with the configuration's
search knobs."""

from __future__ import annotations

import torch


class SlimServerSystem:
    def __init__(self, server, cfg: dict):
        self.server = server
        self.port = server._httpd.server_address[1]
        self.cfg = cfg
        self.info = {"n": int(server.hnsw.graph.n),
                     "dim": int(server.hnsw.vectors.shape[1]),
                     "n_up": int((server.slim.graph.level >= 1).sum())}

    def client(self):
        from hnsw_slim_tpu_torch.serve.client import SlimClient

        return SlimClient(host=self.cfg["server"]["host"], port=self.port,
                          timeout=self.cfg["server"]["client_timeout_s"])

    def close(self) -> None:
        if self.server is not None:
            self.server.shutdown()
            self.server = None


def build(cfg: dict, data, device) -> SlimServerSystem:
    from hnsw_slim_tpu_torch.config import HnswConfig, SearchConfig, SlimConfig
    from hnsw_slim_tpu_torch.serve.server import SlimServer

    s = cfg["server"]
    server = SlimServer(
        data.base, hnsw_cfg=HnswConfig(**cfg["hnsw"]),
        slim_cfg=SlimConfig.from_ratios(**cfg["slim"]),
        build_strategy=s["build_strategy"], host=s["host"], port=0,
        serve_index=s["serve_index"], device=device)
    if abs(server.batcher.window * 1e3 - s["batch_window_ms"]) > 1e-9:
        raise ValueError(f"the server batches over {server.batcher.window} "
                         f"s, the configuration states "
                         f"{s['batch_window_ms']} ms")
    server.slim.scfg = SearchConfig(**cfg["search"])
    server.start_background()
    if torch.cuda.is_available() and server.hnsw.vectors.is_cuda:
        torch.cuda.synchronize()
    return SlimServerSystem(server, cfg)
