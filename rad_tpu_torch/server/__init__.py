"""HTTP serving: remote HNSW index service + coordination endpoints."""

from rad_tpu_torch.server.http_server import (
    HNSWServerApp,
    HNSWServerMetrics,
    create_hnsw_server,
    run_hnsw_server,
)

__all__ = [
    "HNSWServerApp",
    "HNSWServerMetrics",
    "create_hnsw_server",
    "run_hnsw_server",
]
