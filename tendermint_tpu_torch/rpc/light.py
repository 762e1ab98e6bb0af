"""Light-client serving RPC surface (ADR-026).

Deliberately THIN: these handlers only decode canonical proto bytes
and encode verdicts — admission, rate limiting, coalescing and the
follow cursors all live in light/service.py.  An overload refusal from
the serving plane (queue full / per-client rate limit) surfaces as the
same 429-style ``RPC_BUSY_CODE`` + Retry-After hint the mempool
ingress gate uses, so a flooding light client is told to back off
while consensus never sees the load.

Routes (registered by RPCServer when the node runs a LightServe):

  light_verify     one header verification (adjacent / non_adjacent /
                   trusting) against proto-encoded headers + valsets
  light_subscribe  open a bounded follow cursor
  light_poll       advance a follow cursor (proto LightBlocks out);
                   an evicted cursor answers {"evicted": true} — the
                   client re-subscribes
  light_unsubscribe
  light_status     the serving plane's debug report
"""
from __future__ import annotations

import base64
from fractions import Fraction

from tendermint_tpu_torch.rpc.server import RPC_BUSY_CODE, RPCError

# service disabled / not running: distinct from busy so clients don't
# retry a node that will never serve them
RPC_LIGHT_OFF_CODE = -32012


def _serve(node):
    s = getattr(node, "light_serve", None)
    if s is None or not s.is_running():
        raise RPCError(RPC_LIGHT_OFF_CODE, "light serving is disabled")
    return s


def _unb64(v, what: str) -> bytes:
    if not isinstance(v, str):
        raise RPCError(-32602, f"{what} must be base64 proto bytes")
    try:
        return base64.b64decode(v)
    except Exception:  # noqa: BLE001 - caller input
        raise RPCError(-32602, f"{what}: invalid base64")


def _signed_header(v, what: str):
    from tendermint_tpu_torch.types.light_block import SignedHeader
    try:
        return SignedHeader.from_proto(_unb64(v, what))
    except RPCError:
        raise
    except Exception as e:  # noqa: BLE001 - caller input
        raise RPCError(-32602, f"{what}: bad signed header: {e}")


def _valset(v, what: str):
    from tendermint_tpu_torch.types.validator_set import ValidatorSet
    try:
        return ValidatorSet.from_proto(_unb64(v, what))
    except RPCError:
        raise
    except Exception as e:  # noqa: BLE001 - caller input
        raise RPCError(-32602, f"{what}: bad validator set: {e}")


def _trust_level(v) -> Fraction:
    if v is None:
        from tendermint_tpu_torch.light.verifier import DEFAULT_TRUST_LEVEL
        return DEFAULT_TRUST_LEVEL
    try:
        f = Fraction(str(v))
    except (ValueError, ZeroDivisionError):
        raise RPCError(-32602, f"bad trust_level {v!r}")
    if not (0 < f <= 1):
        raise RPCError(-32602, "trust_level must be in (0, 1]")
    return f


def light_verify(server, kind=None, trusted=None, trusted_vals=None,
                 untrusted=None, untrusted_vals=None, now=None,
                 trust_level=None, trusting_period_s=None,
                 max_clock_drift_s=None, client=None):
    """One verification through the serving plane.  Busy verdicts map
    to RPC_BUSY_CODE with a Retry-After hint (429 semantics)."""
    from tendermint_tpu_torch.light.service import LightRequest
    s = _serve(server.node)
    if kind not in ("adjacent", "non_adjacent", "trusting"):
        raise RPCError(-32602, f"bad light verify kind {kind!r}")
    kwargs = {"trust_level": _trust_level(trust_level)}
    if now is not None:
        from tendermint_tpu_torch.types.basic import Timestamp
        sec = float(now)  # epoch seconds on the wire
        kwargs["now"] = Timestamp(int(sec), int((sec - int(sec)) * 1e9))
    if trusting_period_s is not None:
        kwargs["trusting_period_s"] = float(trusting_period_s)
    if max_clock_drift_s is not None:
        kwargs["max_clock_drift_s"] = float(max_clock_drift_s)
    if trusted is not None:
        kwargs["trusted"] = _signed_header(trusted, "trusted")
    if trusted_vals is not None:
        kwargs["trusted_vals"] = _valset(trusted_vals, "trusted_vals")
    if untrusted is not None:
        kwargs["untrusted"] = _signed_header(untrusted, "untrusted")
    if untrusted_vals is not None:
        kwargs["untrusted_vals"] = _valset(untrusted_vals,
                                           "untrusted_vals")
    req = LightRequest(kind, s.chain_id, **kwargs)
    v = s.verify(req, client=str(client or "rpc"))
    if v.retry_after_s is not None:
        ms = int(max(0.0, v.retry_after_s) * 1000)
        raise RPCError(RPC_BUSY_CODE,
                       f"light serve is busy: retry after {ms} ms")
    return {"ok": v.ok, "error": v.error}


def light_subscribe(server, client=None, from_height=None):
    s = _serve(server.node)
    cid = s.subscribe(str(client or "rpc"),
                      int(from_height) if from_height else 0)
    return {"cursor": cid}


def light_poll(server, cursor=None, max_items=None):
    s = _serve(server.node)
    if not cursor:
        raise RPCError(-32602, "cursor is required")
    blocks = s.poll(str(cursor),
                    int(max_items) if max_items else None)
    if blocks is None:
        # evicted under pressure (or never existed): the client
        # re-subscribes from its own trusted height
        return {"evicted": True, "blocks": []}
    return {"evicted": False,
            "blocks": [base64.b64encode(b.proto()).decode()
                       for b in blocks]}


def light_unsubscribe(server, cursor=None):
    s = _serve(server.node)
    if cursor:
        s.unsubscribe(str(cursor))
    return {}


def light_status(server):
    s = getattr(server.node, "light_serve", None)
    if s is None:
        from tendermint_tpu_torch.light import service as lsvc
        return {"enabled": lsvc.enabled(), "running": False}
    return s.report()


def register(server):
    """Called from RPCServer.__init__ — adds the light-serve routes.
    The routes exist even when the plane is disabled so clients get a
    crisp RPC_LIGHT_OFF_CODE instead of method-not-found."""
    server.routes["light_verify"] = \
        lambda **kw: light_verify(server, **kw)
    server.routes["light_subscribe"] = \
        lambda **kw: light_subscribe(server, **kw)
    server.routes["light_poll"] = \
        lambda **kw: light_poll(server, **kw)
    server.routes["light_unsubscribe"] = \
        lambda **kw: light_unsubscribe(server, **kw)
    server.routes["light_status"] = \
        lambda **kw: light_status(server, **kw)
