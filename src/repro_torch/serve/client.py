"""Stdlib Python client for the serve HTTP API (DESIGN.md §16).

``http.client`` only — usable from any environment that can reach the
server, with numpy as the sole (already-required) dependency for panel
upload packing.
"""
from __future__ import annotations

import http.client
import io
import json
import time
from urllib.parse import urlencode

import numpy as np

__all__ = ["ServeClient", "ServeError"]


class ServeError(RuntimeError):
    """An HTTP-level or request-level failure reported by the server."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class ServeClient:
    def __init__(self, host: str, port: int, *, timeout: float = 120.0):
        self.host = host
        self.port = int(port)
        self.timeout = timeout

    # ------------------------------------------------------------ plumbing

    def _request(self, method: str, path: str, body: bytes | None = None,
                 content_type: str = "application/json") -> tuple[int, bytes]:
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout
        )
        try:
            headers = {"Content-Type": content_type} if body else {}
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def _json(self, method: str, path: str, body: bytes | None = None,
              content_type: str = "application/json") -> dict:
        status, raw = self._request(method, path, body, content_type)
        try:
            payload = json.loads(raw)
        except ValueError:
            payload = {"error": raw.decode(errors="replace")}
        if status >= 400:
            raise ServeError(status, payload.get("error", "unknown error"))
        return payload

    # ----------------------------------------------------------------- API

    def healthy(self) -> bool:
        try:
            return bool(self._json("GET", "/healthz").get("ok"))
        except (OSError, ServeError):
            return False

    def metrics(self) -> dict:
        return self._json("GET", "/metrics")

    def studies(self) -> list[dict]:
        return self._json("GET", "/studies")["studies"]

    def admit_study(self, study_id: str, *, genotypes: str, phenotypes: str,
                    covariates: str | None = None, weight: float | None = None,
                    plan: dict | None = None, warm: bool = True) -> dict:
        """Admit a study from paths visible to the SERVER."""
        body = json.dumps({
            "study_id": study_id,
            "genotypes": genotypes,
            "phenotypes": phenotypes,
            "covariates": covariates,
            "weight": weight,
            "plan": plan or {},
            "warm": warm,
        }).encode()
        return self._json("POST", "/studies", body)

    def scan_panel(self, study_id: str, phenotypes, trait_names=None, *,
                   hit_threshold_nlp: float | None = None,
                   weight: float | None = None) -> str:
        """Upload a phenotype panel (n_samples x P) for a full scan
        against a resident study's cohort; returns the request id."""
        buf = io.BytesIO()
        arrays = {"phenotypes": np.asarray(phenotypes)}
        if trait_names is not None:
            arrays["trait_names"] = np.asarray(list(trait_names), dtype="U64")
        np.savez(buf, **arrays)
        q = {"study": study_id, "kind": "panel"}
        if hit_threshold_nlp is not None:
            q["threshold"] = hit_threshold_nlp
        if weight is not None:
            q["weight"] = weight
        payload = self._json(
            "POST", f"/scan?{urlencode(q)}", buf.getvalue(),
            content_type="application/octet-stream",
        )
        return payload["request"]

    def scan_window(self, study_id: str, lo: int, hi: int, *,
                    weight: float | None = None) -> str:
        """Queue a marker-window query [lo, hi) against the resident
        panel; returns the request id."""
        q = {"study": study_id, "kind": "window", "lo": int(lo), "hi": int(hi)}
        if weight is not None:
            q["weight"] = weight
        return self._json("POST", f"/scan?{urlencode(q)}")["request"]

    def request_info(self, rid: str) -> dict:
        return self._json("GET", f"/requests/{rid}")

    def wait(self, rid: str, timeout: float = 600.0,
             poll_s: float = 0.2) -> dict:
        """Poll until the request leaves queued/running; raises
        ``ServeError`` if it failed."""
        deadline = time.time() + timeout
        while True:
            info = self.request_info(rid)
            if info["status"] not in ("queued", "running"):
                if info["status"] != "done":
                    raise ServeError(
                        500, f"request {rid} {info['status']}: {info['error']}"
                    )
                return info
            if time.time() >= deadline:
                raise TimeoutError(f"request {rid} still {info['status']}")
            time.sleep(poll_s)

    def fetch(self, rid: str, name: str) -> bytes:
        """Download one result table (hits.tsv, per_trait_best.tsv,
        qc.tsv) as raw bytes — byte-identical to the offline scan's."""
        status, raw = self._request("GET", f"/requests/{rid}/files/{name}")
        if status >= 400:
            raise ServeError(status, raw.decode(errors="replace"))
        return raw

    def fetch_to(self, rid: str, name: str, path: str) -> str:
        data = self.fetch(rid, name)
        with open(path, "wb") as fh:
            fh.write(data)
        return path

    def shutdown(self) -> dict:
        return self._json("POST", "/shutdown")
