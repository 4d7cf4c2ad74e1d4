"""KV-page migration: move a prompt's page chain between replicas
over the wire (the disaggregated-serving transfer layer).  A copy of
``dtf_tpu/serve/migrate.py``; the wire form is the JAX package's, so a
page payload of either package decodes in the other.

Disaggregated serving (serve/router.py pool roles) runs PREFILL on
one pool of replicas and DECODE on another, which only works if the
prompt's KV pages — computed on a prefill replica — can be re-homed
onto a decode replica.  Pages already have everything a transfer
needs: stable identities (the page pool) and content-addressed names
(the prefix registry's chained digests).  This module is the wire
form: serialization, integrity digests, bounded in-flight windows,
and the client that pulls + verifies + imports a chain.

The protocol rides the existing replica wire (newline-delimited JSON,
serve/replica.py) — a decode replica dials the prefill replica's own
server socket and speaks two ops:

  client → server
    {"op":"page_fetch","xfer":X,"prompt":[...],"lo":L,"n":N}
        request window [L, L+N) of the prompt's page chain.  The
        FIRST fetch of a transfer takes a MIGRATION HOLD on the whole
        chain (engine.export_chain_begin): every held page gets one
        extra pool holder, so refcount ≥ 2 — above the eviction
        scan's refcount-1 bar.  An in-transfer page can therefore
        never be evicted, by construction.
    {"op":"page_fetch","xfer":X,"release":true}
        transfer over (complete OR aborted): drop the hold.  The
        server also drops holds when the connection dies — a vanished
        client cannot pin pages forever.

  server → client
    {"op":"page_push","xfer":X,"depth":D,"digest":CHAIN_DIGEST,
     "tokens":[...],"payload":{"leaves":[...],"digest":SHA1},
     "chain_len":L}
        one page: its depth, its chained content digest, the page's
        OWN token ids, and the serialized KV payload with an
        integrity digest over the raw bytes.
    {"op":"page_push","xfer":X,"end":true,"lo":L,"sent":K,
     "chain_len":L}                       end-of-window marker
    {"op":"page_push","xfer":X,"error":MSG}  server-side failure

VERIFICATION is layered, and each layer catches a different lie:

  payload digest   — sha1 over every leaf's dtype/shape/bytes.  A
      mismatch is a TORN TRANSFER (bit rot, truncation, a bug):
      loud ``migration_torn`` anomaly + bounded re-fetch of that one
      page; repeated tears abort the transfer.
  token comparison — the receiver compares the page's wire-carried
      tokens against ITS OWN prompt slice, byte-for-byte.  A chain
      digest that matches while the tokens differ (hash collision, or
      a corrupted sender) is rejected here — the same
      collision-degrades-to-miss guard the prefix registry applies
      locally, extended over the wire.
  chain digest     — recomputed from the receiver's own prompt and
      compared against the sender's claim; a mismatch means the two
      sides disagree about what prefix this even is.  Abort.

A page that passes all three and is imported (engine.import_chain →
Decoder.write_page) is BIT-IDENTICAL to a locally-prefilled one:
read_page/write_page are exact copies, no casts — the contract the
token-exactness tests pin.

BFLOAT16 on the wire: the JAX wire tags a bfloat16 leaf ``"bfloat16"``
(numpy's name of ml_dtypes' type) and sends its raw bytes.  This package
needs no ml_dtypes: a bfloat16 leaf is its 16-bit words
(``serve/decode.py`` :class:`BF16Words`), tagged and hashed under the
same name, so a port payload and a JAX payload of the same bits are the
same bytes and have the same digest.  :func:`decode_page` maps the tag
back to words, and raises on a tag it does not know.

Bounded in-flight: the client requests ``window`` pages per fetch and
IMPORTS each window into the local pool before requesting the next,
so at most ``window`` pages are ever buffered in host memory,
regardless of chain length.
"""

from __future__ import annotations

import base64
import hashlib
import json
import logging
import os
import socket
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from dtf_tpu_torch import chaos
from dtf_tpu_torch.obs import trace
from dtf_tpu_torch.serve.decode import BF16Words, wire_dtype
from dtf_tpu_torch.serve.engine import _page_digest

log = logging.getLogger("dtf_tpu_torch")

#: pages per fetch window — the in-flight bound (host-memory cap per
#: transfer is window × page payload size)
DEFAULT_WINDOW = 4


class TornTransfer(RuntimeError):
    """A page payload's bytes do not match its integrity digest."""


class MigrationError(RuntimeError):
    """The transfer cannot proceed (peer gone, corrupt chain, starved
    pool) — the caller falls back to local prefill, which is always
    correct, just slower."""


# -- serialization -----------------------------------------------------

def payload_digest(leaves: List[np.ndarray]) -> str:
    """Integrity digest over a page payload: sha1 of every leaf's
    dtype tag, shape and raw bytes, in leaf order.  Covers layout as
    well as content — a reshaped or re-typed leaf with identical bytes
    is still a different page."""
    h = hashlib.sha1()
    for a in leaves:
        tag = wire_dtype(a)
        a = np.ascontiguousarray(a)
        h.update(tag.encode())
        h.update(np.asarray(a.shape, np.int64).tobytes())
        h.update(a.tobytes())
    return h.hexdigest()


def encode_page(leaves: List[np.ndarray]) -> dict:
    """Wire form of one page payload: per-leaf dtype/shape/base64
    bytes plus the integrity digest."""
    return {
        "leaves": [{"dtype": wire_dtype(a),
                    "shape": list(a.shape),
                    "data": base64.b64encode(
                        np.ascontiguousarray(a).tobytes()).decode()}
                   for a in leaves],
        "digest": payload_digest(leaves),
    }


def decode_page(obj: dict) -> List[np.ndarray]:
    """Inverse of :func:`encode_page`.  Recomputes the integrity
    digest over the decoded leaves and raises :class:`TornTransfer`
    when it does not match the sender's claim — the torn-transfer
    detector."""
    leaves = []
    for leaf in obj["leaves"]:
        raw = base64.b64decode(leaf["data"])
        tag = leaf["dtype"]
        if tag == BF16Words.wire_dtype:
            a = np.frombuffer(raw, np.uint16).reshape(
                leaf["shape"]).view(BF16Words)
        else:
            a = np.frombuffer(raw, dtype=_numpy_dtype(tag)).reshape(
                leaf["shape"])
        leaves.append(a)
    got = payload_digest(leaves)
    if got != obj.get("digest"):
        raise TornTransfer(
            f"page payload digest mismatch: wire claims "
            f"{obj.get('digest')!r}, bytes hash to {got!r}")
    return leaves


def _numpy_dtype(tag: str) -> np.dtype:
    """numpy's dtype of a wire tag: only a tag that is numpy's own
    name of a dtype (its ``str``), never a guess."""
    try:
        dt = np.dtype(tag)
    except (TypeError, ValueError):
        dt = None
    if dt is None or str(dt) != tag:
        raise MigrationError(f"unknown dtype tag {tag!r} on the wire")
    return dt


def expected_chain(prompt: np.ndarray, page_size: int) -> List[str]:
    """The chained digests of the prompt's full pages, computed from
    the RECEIVER's own tokens — the reference every wire-carried
    digest is checked against."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    out: List[str] = []
    digest = ""
    for d in range(int(prompt.size) // int(page_size)):
        digest = _page_digest(
            digest, prompt[d * page_size:(d + 1) * page_size])
        out.append(digest)
    return out


def new_xfer_id() -> str:
    """Transfer ids only need uniqueness per (client, connection)."""
    return f"x{os.getpid()}.{time.monotonic_ns()}"


# -- client ------------------------------------------------------------

class _Wire:
    """One blocking JSON-lines connection to a peer replica."""

    def __init__(self, host: str, port: int, timeout: float):
        self.sock = socket.create_connection((host, int(port)),
                                             timeout=timeout)
        self.sock.settimeout(timeout)
        self.rfile = self.sock.makefile("rb")
        self.wfile = self.sock.makefile("wb")
        self._wlock = threading.Lock()

    def send(self, obj: dict) -> None:
        data = (json.dumps(obj) + "\n").encode()
        with self._wlock:
            self.wfile.write(data)
            self.wfile.flush()

    def recv(self) -> dict:
        line = self.rfile.readline()
        if not line:
            raise MigrationError("peer closed the connection mid-transfer")
        return json.loads(line)

    def close(self) -> None:
        for c in (self.rfile, self.wfile, self.sock):
            try:
                c.close()
            except OSError:
                pass


def _verify_page(msg: dict, prompt: np.ndarray, page_size: int,
                 expect: List[str]) -> List[np.ndarray]:
    """All three verification layers for one page_push message.
    Raises TornTransfer (payload bytes) or MigrationError (token /
    chain-digest rejection — not retryable)."""
    depth = int(msg["depth"])
    if depth >= len(expect):
        raise MigrationError(
            f"peer sent depth {depth} but this prompt has only "
            f"{len(expect)} full pages")
    block = np.ascontiguousarray(
        prompt[depth * page_size:(depth + 1) * page_size], np.int32)
    # collision guard: compare the page's TOKENS, not just digests —
    # a colliding digest with different tokens must be rejected, the
    # wire form of the registry's stored-token verification
    wire_tokens = np.asarray(msg.get("tokens", ()), np.int32)
    if wire_tokens.shape != block.shape or not np.array_equal(
            wire_tokens, block):
        raise MigrationError(
            f"depth-{depth} page tokens differ from the local prompt — "
            f"corrupted or foreign chain, rejecting")
    if msg.get("digest") != expect[depth]:
        raise MigrationError(
            f"depth-{depth} chain digest mismatch: peer claims "
            f"{msg.get('digest')!r}, local chain says "
            f"{expect[depth]!r}")
    return decode_page(msg["payload"])   # raises TornTransfer on tear


def fetch_chain(engine, host: str, port: int, prompt,
                *, window: int = DEFAULT_WINDOW,
                io_timeout: float = 30.0,
                max_refetch: int = 2) -> Dict[str, int]:
    """Pull ``prompt``'s page chain from the replica at ``host:port``
    and import it into ``engine``'s pool + registry (the decode-
    replica side of a migration).

    Windows of ``window`` pages bound in-flight data; each window is
    imported before the next is requested.  A torn page (payload
    digest mismatch) raises a loud ``migration_torn`` anomaly and is
    re-fetched up to ``max_refetch`` times; persistent tears — and any
    token/chain-digest rejection — abort with :class:`MigrationError`.
    Returns ``{"pages": imported, "chain_len": peer chain length,
    "torn": tears seen}``."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    page_size = int(engine.page_size)
    expect = expected_chain(prompt, page_size)
    if not expect:
        return {"pages": 0, "chain_len": 0, "torn": 0}
    metrics = getattr(engine, "metrics", None)
    torn_counter = metrics.get("serve_migration_torn_total") \
        if metrics is not None else None
    xfer = new_xfer_id()
    payloads: Dict[int, List[np.ndarray]] = {}
    imported = 0
    torn = 0
    chain_len: Optional[int] = None
    wire = _Wire(host, port, io_timeout)
    try:
        lo = 0
        while chain_len is None or lo < chain_len:
            # chaos page_fetch_stall@replica<K>:<S>: each window on
            # replica K waits S extra seconds — the slow-fabric
            # signature the router's migration timeout must absorb
            # without losing requests or token exactness
            stall = chaos.page_fetch_stall()
            if stall > 0:
                time.sleep(stall)
            wire.send({"op": "page_fetch", "xfer": xfer,
                       "prompt": [int(t) for t in prompt],
                       "lo": lo, "n": int(window)})
            got: Dict[int, List[np.ndarray]] = {}
            while True:
                msg = wire.recv()
                if msg.get("op") != "page_push" \
                        or msg.get("xfer") != xfer:
                    continue              # stale cross-talk — skip
                if msg.get("error"):
                    raise MigrationError(
                        f"peer aborted transfer: {msg['error']}")
                if msg.get("end"):
                    chain_len = int(msg["chain_len"])
                    break
                depth = int(msg["depth"])
                try:
                    got[depth] = _verify_page(msg, prompt, page_size,
                                              expect)
                except TornTransfer as e:
                    torn += 1
                    if torn_counter is not None:
                        torn_counter.inc()
                    trace.anomaly("migration_torn", depth=depth,
                                  xfer=xfer, error=str(e))
                    trace.flush()
                    log.error("migrate: torn page at depth %d (%s) — "
                              "re-fetching", depth, e)
                    if torn > max_refetch:
                        raise MigrationError(
                            f"{torn} torn pages — aborting (last: {e})"
                        ) from e
            # re-fetch any page of this window that arrived torn (one
            # page at a time: the tear already proved this path flaky)
            hi = min(lo + int(window), chain_len)
            missing = [d for d in range(lo, hi) if d not in got]
            for d in missing:
                wire.send({"op": "page_fetch", "xfer": xfer,
                           "prompt": [int(t) for t in prompt],
                           "lo": d, "n": 1})
                while True:
                    msg = wire.recv()
                    if msg.get("op") != "page_push" \
                            or msg.get("xfer") != xfer:
                        continue
                    if msg.get("error"):
                        raise MigrationError(
                            f"peer aborted transfer: {msg['error']}")
                    if msg.get("end"):
                        break
                    try:
                        got[int(msg["depth"])] = _verify_page(
                            msg, prompt, page_size, expect)
                    except TornTransfer as e:
                        torn += 1
                        if torn_counter is not None:
                            torn_counter.inc()
                        trace.anomaly("migration_torn",
                                      depth=int(msg["depth"]),
                                      xfer=xfer, error=str(e))
                        trace.flush()
                        if torn > max_refetch:
                            raise MigrationError(
                                f"{torn} torn pages — aborting "
                                f"(last: {e})") from e
                if d not in got:
                    raise MigrationError(
                        f"depth-{d} page unrecoverable after re-fetch")
            payloads.update(got)
            # commit this window before requesting the next: the
            # cumulative contiguous chain [0, hi) imports; already-
            # imported depths are skipped inside import_chain
            if all(d in payloads for d in range(hi)):
                imported = engine.import_chain(
                    prompt, [payloads[d] for d in range(hi)]) + imported
            lo = hi
        return {"pages": imported, "chain_len": int(chain_len),
                "torn": torn}
    finally:
        try:
            wire.send({"op": "page_fetch", "xfer": xfer,
                       "release": True})
        except (OSError, ValueError):
            pass                  # peer gone: its conn teardown
            # releases the hold server-side
        wire.close()
