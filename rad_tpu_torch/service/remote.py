"""RemoteHNSWService: HTTP client to a rad_tpu_torch (or compatible) index
server, on the standard library alone.

The client of ``rad_tpu.service.remote``, with ``http.client`` in place of
``requests``: a pool of keep-alive connections (``pool_connections``
idle ones kept), retry with exponential backoff on 429/5xx and on
connection errors, ``ValueError`` on any other 4xx, the builtin
``ConnectionError`` after the last attempt, Bearer auth,
``X-Correlation-ID`` request headers, and cached health checks. Also
provides :class:`RemoteCoordinationClient`, which lets a
:class:`rad_tpu_torch.traverse.workers.ScoringWorker` on another machine
join a traversal through the server's ``/coordination`` endpoints.
"""

from __future__ import annotations

import http.client
import json
import logging
import queue
import time
import urllib.parse
import uuid
from typing import List, Optional

from rad_tpu_torch.service.base import HNSWService
from rad_tpu_torch.traverse.coordinator import WorkItem

logger = logging.getLogger(__name__)

__all__ = ["RemoteHNSWService", "RemoteCoordinationClient"]

_RETRY_STATUSES = {429, 500, 502, 503, 504}
# a pooled keep-alive connection the server has since closed fails like
# this before any response; the request is resent once on a fresh one
_STALE = (http.client.RemoteDisconnected, ConnectionResetError,
          BrokenPipeError)


class _RetryableStatus(Exception):
    """A 429/5xx answer: retried like a connection error."""


class RemoteHNSWService(HNSWService):
    def __init__(
        self,
        base_url: str,
        api_key: Optional[str] = None,
        timeout: float = 30.0,
        max_retries: int = 3,
        backoff_factor: float = 0.3,
        pool_connections: int = 10,
        health_cache_seconds: float = 5.0,
        service_name: str = "remote",
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.timeout = timeout
        self.max_retries = max_retries
        self.backoff_factor = backoff_factor
        self.service_name = service_name
        self.health_cache_seconds = health_cache_seconds
        url = urllib.parse.urlsplit(self.base_url)
        if url.scheme not in ("http", "https") or not url.hostname:
            raise ValueError(f"not an http(s) URL: {base_url!r}")
        self._conn_cls = (http.client.HTTPSConnection
                          if url.scheme == "https"
                          else http.client.HTTPConnection)
        self._netloc = (url.hostname, url.port)
        self._prefix = url.path
        self._headers = {"Accept": "application/json"}
        if api_key:
            self._headers["Authorization"] = f"Bearer {api_key}"
        # idle keep-alive connections; a busy caller opens more and keeps
        # at most pool_connections of them when they come back
        self._idle: queue.LifoQueue = queue.LifoQueue(
            maxsize=max(int(pool_connections), 1))
        self._shutdown = False
        self._started_at = time.time()
        self._request_count = 0
        self._error_count = 0
        self._health: Optional[bool] = None
        self._health_checked_at = 0.0

    # ------------------------------------------------------------ plumbing
    def _connection(self):
        try:
            return self._idle.get_nowait(), True
        except queue.Empty:
            host, port = self._netloc
            return self._conn_cls(host, port, timeout=self.timeout), False

    def _release(self, conn) -> None:
        try:
            self._idle.put_nowait(conn)
        except queue.Full:
            conn.close()

    def _send(self, method: str, path: str, body: Optional[bytes],
              headers: dict):
        """One HTTP exchange → (status, body bytes)."""
        while True:
            conn, reused = self._connection()
            try:
                conn.request(method, self._prefix + path, body=body,
                             headers=headers)
                resp = conn.getresponse()
                data = resp.read()
            except _STALE:
                conn.close()
                if reused:
                    continue
                raise
            except BaseException:
                conn.close()
                raise
            if resp.will_close:
                conn.close()
            else:
                self._release(conn)
            return resp.status, data

    def _request(self, method: str, path: str, json_body=None) -> dict:
        if self._shutdown:
            raise RuntimeError("service has been shut down")
        url = f"{self.base_url}{path}"
        headers = dict(self._headers)
        headers["X-Correlation-ID"] = str(uuid.uuid4())
        body = None
        if json_body is not None:
            body = json.dumps(json_body).encode()
            headers["Content-Type"] = "application/json"
        last_exc: Exception | None = None
        for attempt in range(self.max_retries + 1):
            try:
                self._request_count += 1
                status, data = self._send(method, path, body, headers)
                if status in _RETRY_STATUSES:
                    raise _RetryableStatus(f"{status} from {url}")
                if status >= 400:
                    self._error_count += 1
                    detail = ""
                    try:
                        detail = json.loads(data).get("detail", "")
                    except Exception:
                        pass
                    raise ValueError(f"HTTP {status} for {path}: {detail}")
                return json.loads(data)
            except ValueError:
                raise
            except Exception as e:  # connection errors + retryable statuses
                last_exc = e
                self._error_count += 1
                if attempt < self.max_retries:
                    delay = self.backoff_factor * (2 ** attempt)
                    logger.warning("retrying %s %s in %.2fs (%s)", method,
                                   path, delay, e)
                    time.sleep(delay)
        raise ConnectionError(
            f"request to {url} failed after {self.max_retries + 1} "
            f"attempts: {last_exc}")

    # ------------------------------------------------------------ contract
    def get_neighbors(self, node_id: int, level: int) -> List:
        data = self._request("GET", f"/neighbors/{int(node_id)}/{int(level)}")
        return data["neighbors"]

    def get_top_level_nodes(self) -> List:
        return self._request("GET", "/top-level-nodes")["nodes"]

    def is_healthy(self) -> bool:
        now = time.time()
        if (self._health is not None
                and now - self._health_checked_at < self.health_cache_seconds):
            return self._health
        try:
            data = self._request("GET", "/health")
            self._health = data.get("status") == "healthy"
        except Exception:
            self._health = False
        self._health_checked_at = now
        return self._health

    def shutdown(self) -> None:
        self._shutdown = True
        while True:
            try:
                self._idle.get_nowait().close()
            except queue.Empty:
                break

    def get_service_info(self) -> dict:
        return {
            "service_type": "remote",
            "service_name": self.service_name,
            "base_url": self.base_url,
            "healthy": self.is_healthy(),
            "uptime_seconds": time.time() - self._started_at,
            "request_count": self._request_count,
            "error_count": self._error_count,
        }

    def get_hnsw_info(self) -> dict:
        return self._request("GET", "/info")["hnsw"]


class RemoteCoordinationClient:
    """Worker-facing coordination API over HTTP.

    Duck-types the subset of :class:`CoordinationService` that
    :class:`ScoringWorker` uses, so a worker process on any machine can be
    pointed at a traversal server:

        coord = RemoteCoordinationClient("http://head:8000")
        ScoringWorker(coord, my_docking_fn).start()
    """

    def __init__(self, base_url: str, api_key: Optional[str] = None,
                 heartbeat_interval: float = 10.0, **kwargs) -> None:
        self._svc = RemoteHNSWService(base_url, api_key=api_key, **kwargs)
        self.heartbeat_interval = heartbeat_interval
        self.scored_set = _RemoteScoredProxy(self._svc)

    def register_worker(self, worker_id: str) -> dict:
        out = self._svc._request("POST", "/coordination/register",
                                 {"worker_id": worker_id})
        self.heartbeat_interval = float(
            out.get("heartbeat_interval", self.heartbeat_interval))
        return out

    def worker_heartbeat(self, worker_id: str) -> bool:
        return bool(self._svc._request("POST", "/coordination/heartbeat",
                                       {"worker_id": worker_id})["ok"])

    def unregister_worker(self, worker_id: str) -> None:
        pass  # server-side timeout reaps silently-departed workers

    def request_work(self, worker_id: str) -> Optional[WorkItem]:
        out = self._svc._request("POST", "/coordination/request-work",
                                 {"worker_id": worker_id})
        return WorkItem.from_dict(out["work"]) if out.get("work") else None

    def submit_work_results(self, worker_id: str, work_id: str,
                            results) -> bool:
        return bool(self._svc._request(
            "POST", "/coordination/submit-results",
            {"worker_id": worker_id, "work_id": work_id,
             "results": [[int(i), float(s), str(sm)]
                         for i, s, sm in results]})["ok"])

    def report_worker_error(self, worker_id: str, error: str) -> None:
        self._svc._request("POST", "/coordination/error",
                           {"worker_id": worker_id, "error": error})

    def fail_work(self, worker_id: str, work_id: str) -> bool:
        """Release a failed work item for immediate requeue (an older
        server without the route reaps it via the stale GC instead)."""
        try:
            return bool(self._svc._request(
                "POST", "/coordination/fail",
                {"worker_id": worker_id, "work_id": work_id})["ok"])
        except ValueError:
            return False  # 404 from a pre-fail_work server

    def get_coordination_stats(self) -> dict:
        return self._svc._request("GET", "/coordination/stats")

    def shutdown(self) -> None:
        self._svc.shutdown()


class _RemoteScoredProxy:
    """Score-lookup view used by workers for pre-scoring dedup."""

    def __init__(self, svc: RemoteHNSWService) -> None:
        self._svc = svc

    def getScore(self, node_id: int):
        return self._svc._request(
            "GET", f"/coordination/score/{int(node_id)}")["score"]

    def get_scores_batch(self, node_ids):
        out = self._svc._request("POST", "/coordination/scores",
                                 {"node_ids": [int(i) for i in node_ids]})
        return {int(k): v for k, v in out["scores"].items()}
