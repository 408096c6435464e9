"""Typed per-request errors for the serving stack (port of
``repro/serving/errors.py``).

A :class:`RequestError` always names the request (``uid``) it belongs to: a
malformed submission is rejected at validation, and a runtime fault is
quarantined (``finish_reason="failed"``, slot vacated, pages freed), so one
request's fault never escapes as a shape error or a NaN in the shared
decode batch.
"""
from __future__ import annotations


class RequestError(Exception):
    """A per-request failure: a submit-time validation rejection or a
    quarantined runtime fault.

    Attributes:
        uid:  the offending request's uid.
        kind: ``"invalid"`` (validation), ``"prefill"`` (admission prefill
              raised or gave non-finite logits) or ``"decode"`` (non-finite
              logits on a decode step).
    """

    def __init__(self, uid: int, message: str, *, kind: str = "invalid"):
        self.uid = uid
        self.kind = kind
        super().__init__(f"request {uid}: {message}")
