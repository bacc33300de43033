"""HTTP client for :class:`repro_torch.serve.server.PlanServer` (stdlib-only).

The port's copy of ``repro/serve/client.py``, with the reference's wire
format.

One class, three calls::

    client = PlanClient(f"http://localhost:{server.port}")
    art = client.plan(problem)            # -> PlanArtifact (parity-tested
                                          #    against direct Session.solve)
    client.healthz()                      # -> {"status": "ok", ...}
    client.metrics_text()                 # -> Prometheus exposition text

Requests encode (problem, policy) with the canonical artifact helpers
(:func:`repro_torch.api.artifact.problem_to_dict` /
:func:`~repro_torch.api.artifact.policy_to_dict`) and responses decode through
``PlanArtifact.from_dict`` — the client-side artifact is therefore the
exact deserialization of what a direct solve would have serialized, so
``served.diff(direct)`` is the parity check (asserted in the served-smoke
test and the CI step).

Error mapping (the server's status contract): 429 raises
:class:`~repro_torch.serve.server.ServerBusy`, 503 :class:`ServerClosed`, 504
:class:`DeadlineExceeded`, everything else :class:`PlanRequestError` with
the server's error document attached.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

from .server import DeadlineExceeded, ServerBusy, ServerClosed

__all__ = ["PlanClient", "PlanRequestError"]


class PlanRequestError(RuntimeError):
    """A non-retryable server/protocol error; carries the error document."""

    def __init__(self, status: int, doc: dict):
        super().__init__(f"HTTP {status}: {doc.get('error', 'unknown')}")
        self.status = status
        self.doc = doc


class PlanClient:
    """See module docstring.  ``timeout_s`` bounds every HTTP round trip
    (connect + response); per-request solve deadlines ride in the body."""

    def __init__(self, base_url: str, timeout_s: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s

    # ---------------- planning ----------------

    def plan(self, problem, policy=None, deadline_s: float | None = None):
        """Solve ``problem`` on the server; returns the PlanArtifact."""
        from repro_torch.api.artifact import (
            PlanArtifact,
            policy_to_dict,
            problem_to_dict,
        )

        body = {
            "problem": problem_to_dict(problem),
            "policy": policy_to_dict(policy) if policy is not None else None,
            "deadline_s": deadline_s,
        }
        doc = self._post("/v1/plan", body)
        return PlanArtifact.from_dict(doc["artifact"])

    # ---------------- observability ----------------

    def healthz(self) -> dict:
        """The server's health document (also 200-vs-503 readiness)."""
        try:
            with urllib.request.urlopen(
                self.base_url + "/healthz", timeout=self.timeout_s
            ) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return json.loads(e.read())  # 503 while draining still has a body

    def metrics_text(self) -> str:
        """The Prometheus exposition text the server scrapes from."""
        with urllib.request.urlopen(
            self.base_url + "/metrics", timeout=self.timeout_s
        ) as resp:
            return resp.read().decode()

    # ---------------- transport ----------------

    def _post(self, path: str, body: dict) -> dict:
        data = json.dumps(body).encode()
        req = urllib.request.Request(
            self.base_url + path, data=data,
            headers={"Content-Type": "application/json"}, method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            try:
                doc = json.loads(e.read())
            except Exception:
                doc = {"error": str(e), "kind": "http"}
            if e.code == 429:
                raise ServerBusy(doc.get("error", "busy")) from None
            if e.code == 503:
                raise ServerClosed(doc.get("error", "closed")) from None
            if e.code == 504:
                raise DeadlineExceeded(doc.get("error", "deadline")) from None
            raise PlanRequestError(e.code, doc) from None
