"""Dependency-free HTTP front end for ``ServeHost`` (DESIGN.md §16).

Stdlib only (``http.server.ThreadingHTTPServer``): JSON for control,
``.npz`` bytes for phenotype panel upload, TSV bytes for results.

Endpoints
---------
GET  /healthz                       liveness
GET  /metrics                       serve metrics (latency percentiles,
                                    queue depth, cache hit rates)
GET  /studies                       resident studies
POST /studies                       admit a study from server-side paths
                                    (JSON body: study_id, genotypes,
                                    phenotypes, covariates?, plan?,
                                    weight?, warm?)
POST /scan?study=S&kind=panel       body = npz with ``phenotypes``
         [&threshold=..][&weight=..]  (and optional ``trait_names``)
POST /scan?study=S&kind=window&lo=..&hi=..[&weight=..]
                                    -> {"request": rid} (both kinds)
GET  /requests/<rid>                request status/summary
GET  /requests/<rid>/files/<name>   hits.tsv | per_trait_best.tsv | qc.tsv
POST /shutdown                      clean stop (releases slots, joins
                                    workers, then stops the listener)
"""
from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from repro_torch.serve.requests import ServeHost

__all__ = ["ServeServer"]


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "repro-torch-serve/1"

    # The ServeServer instance is attached to the HTTP server object.
    @property
    def host(self) -> ServeHost:
        return self.server.serve_host  # type: ignore[attr-defined]

    def log_message(self, format, *args):  # noqa: A002 — stdlib signature
        if self.server.serve_verbose:  # type: ignore[attr-defined]
            super().log_message(format, *args)

    # ------------------------------------------------------------- plumbing

    def _json(self, payload, status: int = 200) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, status: int, message: str) -> None:
        self._json({"error": message}, status=status)

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

    def _send_file(self, path: str) -> None:
        try:
            with open(path, "rb") as fh:
                data = fh.read()
        except OSError as e:
            self._error(404, f"result file unavailable: {e}")
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/tab-separated-values")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    # ------------------------------------------------------------------ GET

    def do_GET(self) -> None:  # noqa: N802 — stdlib naming
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        try:
            if url.path == "/healthz":
                self._json({"ok": True})
            elif url.path == "/metrics":
                self._json(self.host.metrics_summary())
            elif url.path == "/studies":
                self._json({"studies": self.host.studies()})
            elif len(parts) == 2 and parts[0] == "requests":
                self._json(self.host.request_info(parts[1]))
            elif len(parts) == 4 and parts[0] == "requests" and parts[2] == "files":
                self._send_file(self.host.result_path(parts[1], parts[3]))
            else:
                self._error(404, f"no route for GET {url.path}")
        except KeyError as e:
            self._error(404, str(e))
        except Exception as e:  # noqa: BLE001 — report, don't kill listener
            self._error(500, f"{type(e).__name__}: {e}")

    # ----------------------------------------------------------------- POST

    def do_POST(self) -> None:  # noqa: N802 — stdlib naming
        url = urlparse(self.path)
        try:
            if url.path == "/studies":
                self._post_study()
            elif url.path == "/scan":
                self._post_scan(parse_qs(url.query))
            elif url.path == "/shutdown":
                self._json({"ok": True})
                self.server.serve_shutdown()  # type: ignore[attr-defined]
            else:
                self._error(404, f"no route for POST {url.path}")
        except (KeyError, ValueError) as e:
            self._error(400, str(e))
        except Exception as e:  # noqa: BLE001 — report, don't kill listener
            self._error(500, f"{type(e).__name__}: {e}")

    def _post_study(self) -> None:
        spec = json.loads(self._body() or b"{}")
        from repro_torch.api import GridSpec, IOSpec, LmmSpec, Study

        study = Study.from_files(
            spec["genotypes"],
            spec["phenotypes"],
            spec.get("covariates"),
        )
        # JSON carries nested spec dicts; rebuild the typed specs the plan
        # API takes (unknown keys raise, reported as a 400).
        plan = dict(spec.get("plan") or {})
        for key, cls in (("grid", GridSpec), ("lmm", LmmSpec), ("io", IOSpec)):
            if isinstance(plan.get(key), dict):
                plan[key] = cls(**plan[key])
        info = self.host.admit_study(
            spec["study_id"], study,
            weight=spec.get("weight"),
            **plan,
        )
        if spec.get("warm", True):
            info["warm"] = self.host.warm_study(spec["study_id"])
        self._json(info)

    def _post_scan(self, q: dict) -> None:
        study = q["study"][0]
        kind = (q.get("kind") or ["panel"])[0]
        weight = float(q["weight"][0]) if "weight" in q else None
        if kind == "window":
            rid = self.host.submit_window(
                study, int(q["lo"][0]), int(q["hi"][0]), weight=weight
            )
        elif kind == "panel":
            with np.load(io.BytesIO(self._body()), allow_pickle=False) as z:
                panel = z["phenotypes"]
                names = (
                    [str(t) for t in z["trait_names"]]
                    if "trait_names" in z.files else None
                )
            threshold = (
                float(q["threshold"][0]) if "threshold" in q else None
            )
            rid = self.host.submit_panel(
                study, panel, names,
                hit_threshold_nlp=threshold, weight=weight,
            )
        else:
            raise ValueError(f"unknown scan kind {kind!r}")
        self._json({"request": rid})


class ServeServer:
    """The listener: binds, serves on a background thread, and owns clean
    shutdown ordering (stop accepting -> drain host -> join)."""

    def __init__(self, host: ServeHost, *, bind: str = "127.0.0.1",
                 port: int = 0, verbose: bool = False):
        self.host = host
        self._httpd = ThreadingHTTPServer((bind, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.serve_host = host  # type: ignore[attr-defined]
        self._httpd.serve_verbose = verbose  # type: ignore[attr-defined]
        self._httpd.serve_shutdown = self.shutdown_async  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None
        self._closer: threading.Thread | None = None
        self._down = threading.Event()      # shutdown begun
        self._stopped = threading.Event()   # shutdown complete

    @property
    def address(self) -> tuple[str, int]:
        return self._httpd.server_address[:2]

    def start(self) -> "ServeServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name="serve-http",
        )
        self._thread.start()
        return self

    def shutdown_async(self) -> None:
        """Trigger shutdown from a handler thread (POST /shutdown) without
        deadlocking on the listener's own join."""
        closer = threading.Thread(target=self.shutdown, daemon=True,
                                  name="serve-http-shutdown")
        self._closer = closer
        closer.start()

    def shutdown(self) -> None:
        if self._down.is_set():
            return
        self._down.set()
        try:
            self._httpd.shutdown()          # stop accepting new requests
            self.host.shutdown()            # drain/fail in-flight, free slots
            self._httpd.server_close()
            if self._thread is not None and self._thread is not threading.current_thread():
                self._thread.join(timeout=10.0)
        finally:
            self._stopped.set()

    def wait(self) -> None:
        """Block until shutdown completes — the listener closed, the host's
        workers joined and its slots released — (the ``serve`` subcommand's
        foreground loop; interruptible by signals)."""
        while not self._stopped.wait(timeout=0.5):
            pass
        if self._closer is not None and self._closer is not threading.current_thread():
            self._closer.join()
