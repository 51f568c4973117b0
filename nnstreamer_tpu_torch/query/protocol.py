"""Tensor wire protocol for among-device streams.

The port of ``nnstreamer_tpu/query/protocol.py``: the same wire revision
('NNSV'), byte for byte, so either package's clients and servers talk to
the other's.

The transport role of libnnstreamer-edge (reference:
gst/nnstreamer/tensor_query/tensor_query_common.h — TCP default, caps
exchanged as strings; mqtt header layout gst/mqtt/mqttcommon.h:29-61).
TPU-native framing: length-prefixed messages over a stream socket; each DATA
frame carries pts + client id + N tensors, every tensor prefixed with the
framework's 128-byte meta header (``tensor/meta.py``), so both
static and flexible streams ride the same format.

Message layout (little endian):
  u32 magic 'NNST' | u8 type | u64 client_id | u64 seq | i64 pts
  | i64 epoch_us | u64 trace_id | u64 span_id | i64 origin_us
  | u32 payload_crc | u32 payload_len | payload
``epoch_us`` is the sender's stream-origin wall clock (NTP-aligned unix
epoch µs, 0 = unknown) — the role of the reference mqtt header's
``base_time_epoch`` (gst/mqtt/mqttcommon.h:54) that lets a receiving
pipeline re-base PTS from another device onto its own clock.
``trace_id``/``span_id``/``origin_us`` are the distributed trace
context (obs/span.py TraceContext; all zeros = untraced): the trace id
names the whole distributed trace so client and server spans merge
under one timeline, the span id is the sender-side parent span, and
origin_us is the source stamp (sender wall µs at buffer birth) that
makes cross-process interlatency computable after clock-offset
estimation (obs/clock.py).
``payload_crc`` is CRC-32C of the payload when the sender has the native
tensorwire kernels (0 = unchecked — the pure-Python CRC would serialize
the hot path; ``native.py`` builds them); receivers verify only nonzero
values, so mixed native/fallback hosts interoperate.
Types: 1=HELLO (payload = caps string utf8 server→client; client→server
the payload may carry a ``qos=<gold|silver|bronze>`` QoS-class
declaration for admission control — query/overload.py), 2=DATA,
3=REPLY, 4=BYE, 5=ERROR (payload = message), 6=PING, 7=PONG, 8=TRACE
(payload = JSON span batch — the server's timeline piggyback, sent
right after a REPLY when the serving pipeline records spans; clients
without a tracer just discard it), 9=SHED (explicit load-shed answer
to a DATA frame refused by admission control: seq echoes the refused
request, payload is the ASCII retry-after hint in milliseconds — an
overloaded or draining server answers every rejected request, no
silent drops), 10=METRICS (payload = JSON metrics-snapshot delta from a
worker process to a telemetry collector — obs/federation.py; seq is the
publisher's push counter, epoch_us the publisher's wall clock at push.
One-way: the collector never replies, so a publisher riding an existing
query connection costs the serving path nothing).
``PING``/``PONG`` are the liveness heartbeat (query/resilience.py): any
peer may send PING at any time; the receiver echoes seq and payload back
as PONG immediately, out of band with DATA/REPLY.  The sender matches
PONGs by seq and derives RTT — the keep-alive role of libnnstreamer-edge's
connection monitoring.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import struct
import time
from typing import Any, List, Optional, Sequence

import numpy as np

from ..pipeline.tracing import annotate, annotation_active, record_copy
from ..tensor.buffer import TensorBuffer, TensorBufferPool
from ..tensor.info import TensorInfo
from ..tensor.meta import META_HEADER_SIZE, TensorMetaInfo

# Wire revision 6 ('NNSV'): + T_METRICS telemetry-federation pushes
# ('NNSU' lacked them, 'NNST' lacked T_SHED/qos, 'NNSS' lacked the
# trace context, 'NNSR' lacked payload_crc, 'NNSQ' also lacked
# epoch_us).  The magic doubles as the version stamp — a peer speaking
# another revision fails immediately with "bad magic" instead of
# desynchronizing the stream (a rev-5 collector would silently drop a
# worker's metric pushes and the fleet view would show a healthy-
# looking hole exactly where the telemetry plane disagreed on dialect).
MAGIC = 0x4E4E5356  # 'NNSV'
HEADER = struct.Struct("<IBQQqqQQqII")
#: upper bound on a wire-declared payload (default 1 GiB, env-overridable):
#: receives reject anything larger before allocating, so a corrupted
#: length field cannot OOM the receiver (a 4K RGB uncompressed frame is
#: ~25 MB; 1 GiB leaves 40x headroom for batched/multi-tensor frames)
MAX_WIRE_PAYLOAD = int(os.environ.get("NNS_MAX_WIRE_PAYLOAD",
                                      str(1 << 30)))

(T_HELLO, T_DATA, T_REPLY, T_BYE, T_ERROR, T_PING, T_PONG, T_TRACE,
 T_SHED, T_METRICS) = 1, 2, 3, 4, 5, 6, 7, 8, 9, 10


def parse_retry_after(payload, default_s: float = 0.1) -> float:
    """The ``T_SHED`` payload contract in ONE place: ASCII retry-after
    milliseconds → seconds, ``default_s`` on an empty or malformed
    payload.  Both reply consumers (QueryConnection's request/response
    path and the llm tier's TokenStreamClient) parse through here so
    the wire format can never silently diverge between them."""
    try:
        return int(bytes(payload or b"") or b"100") / 1e3
    except ValueError:
        return float(default_s)


def parse_hello_tokens(payload) -> dict:
    """Client→server T_HELLO payload grammar: ``;``-separated
    ``key=value`` tokens (``qos=gold;model=resnet``).  Grown from the
    original bare ``qos=<class>`` payload — a single token parses
    identically, so old clients need no change; unknown tokens are kept
    so the grammar can extend without a wire revision.  The ``model``
    token is the fleet router's consistent-hash key
    (fleet/router.py)."""
    out = {}
    for part in bytes(payload or b"").decode("utf-8",
                                             "replace").split(";"):
        key, sep, val = part.partition("=")
        if sep and key:
            out[key.strip()] = val.strip()
    return out


def create_connection(address, timeout=None):
    """``socket.create_connection`` with a loopback self-connect guard.

    A connect retried against a local port with no listener (every
    reconnect/resubscribe loop in this package does exactly that while
    the peer is down) can be assigned that very port as its ephemeral
    local port and "succeed" via TCP simultaneous open — the socket is
    connected to itself, reads back its own writes, and squats on the
    peer's port without SO_REUSEADDR so the real server can't bind when
    it restarts.  Detect it and fail like the refused connect it should
    have been, so retry policies keep backing off.
    """
    sock = socket.create_connection(address, timeout=timeout)
    try:
        self_connected = sock.getsockname() == sock.getpeername()
    except OSError:        # reset under us: let the caller's I/O surface it
        self_connected = False
    if self_connected:
        sock.close()
        raise ConnectionRefusedError(
            f"self-connect to {address[0]}:{address[1]} "
            "(no listener on port)")
    return sock


def shutdown_close(sock) -> None:
    """Tear a socket down so every observer notices immediately.

    ``close()`` alone does not wake a thread blocked in ``recv`` on the
    same fd — the in-flight syscall keeps the kernel socket alive, no FIN
    is sent, and both that thread and the remote peer block forever (it
    also keeps an accepted socket squatting on the listener's port, so a
    restarted server can't bind).  ``shutdown(SHUT_RDWR)`` delivers EOF
    to local readers and a FIN to the peer first; then the fd closes.
    """
    if sock is None:
        return
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


_CRC_FN = None  # resolved once: callable | False (unavailable)


def _crc_fn():
    """Native CRC-32C, resolved once so the per-message hot path is
    lock-free afterwards.  While a background build of the native lib is
    still running this returns None without caching, so CRC kicks in as
    soon as the build lands."""
    global _CRC_FN
    if _CRC_FN is not None:
        return _CRC_FN or None
    from .. import native

    fn = native.crc32c_fn()   # closure over the loaded lib: no locks/frame
    if fn is not None:
        _CRC_FN = fn
        return fn
    if native._tried:   # definitively unavailable (build failed/absent)
        _CRC_FN = False
    return None


def _payload_crc(payload: bytes) -> int:
    """CRC-32C via the native kernels; 0 (= unchecked) without them."""
    fn = _crc_fn() if payload else None
    if fn is None:
        return 0
    return fn(payload) or 1  # reserve 0 for "absent"


@dataclasses.dataclass
class Message:
    type: int
    client_id: int = 0
    seq: int = 0
    pts: int = 0
    epoch_us: int = 0
    #: distributed trace context (obs/span.py; all zeros = untraced)
    trace_id: int = 0
    span_id: int = 0
    origin_us: int = 0
    #: bytes for control messages; may be a memoryview into a pooled
    #: slab when received via ``recv_msg(sock, pool=...)``
    payload: Any = b""
    #: pool ownership handle for a pooled payload (attach to the
    #: TensorBuffer built from this message so the slab outlives the
    #: zero-copy tensor views)
    lease: Any = dataclasses.field(default=None, repr=False)
    #: received payload CRC (kept so a relay — the edge broker — can
    #: forward the payload without recomputing or re-materializing it)
    crc: int = 0


def pack(msg: Message) -> bytes:
    payload = msg.payload
    if not isinstance(payload, bytes):
        payload = bytes(payload)
    return HEADER.pack(MAGIC, msg.type, msg.client_id, msg.seq,
                       msg.pts, msg.epoch_us, msg.trace_id, msg.span_id,
                       msg.origin_us, _payload_crc(payload),
                       len(payload)) + payload


def tensor_parts(buf: TensorBuffer) -> List[Any]:
    """DATA payload as an iovec: ``[count_u32, meta, view, meta, view…]``.

    Tensor payloads stay zero-copy memoryviews over the source arrays
    (a device tensor materializes on the host here, one sync a tensor:
    a transfer, not a framing copy; the query serversink hands a
    bucket's rows over as host views, so its replies make none; a
    non-contiguous host array pays one compaction copy, reported via
    tracing.record_copy).  Only the 4-byte count and the
    128-byte per-tensor meta headers are fresh bytes.
    """
    parts: List[Any] = [struct.pack("<I", buf.num_tensors)]
    for i in range(buf.num_tensors):
        arr = buf.np(i)
        meta = TensorMetaInfo.from_info(TensorInfo.from_np(arr))
        parts.append(meta.to_bytes())
        if not arr.flags.c_contiguous:
            arr = np.ascontiguousarray(arr)
            record_copy(arr.nbytes)
        parts.append(arr.reshape(-1).view(np.uint8).data)
    return parts


def _parts_crc(parts: Sequence[Any]) -> int:
    """Incremental CRC-32C over the iovec (native kernels chain via the
    seed argument; 0 = unchecked without them)."""
    fn = _crc_fn()
    if fn is None:
        return 0
    crc = 0
    for p in parts:
        crc = fn(p, crc)
    return crc or 1  # reserve 0 for "absent"


def sendmsg_all(sock: socket.socket, parts: Sequence[Any]) -> None:
    """``sendall`` for an iovec: one ``socket.sendmsg`` gathers every
    part in kernel space — no ``b"".join`` flattening — looping on
    partial sends."""
    parts = [p if isinstance(p, (bytes, memoryview)) else memoryview(p)
             for p in parts]
    total = sum(len(p) for p in parts)
    sent = 0
    while sent < total:
        n = sock.sendmsg(parts)
        sent += n
        if sent >= total:
            return
        # partial send: drop whole parts, slice the straddling one
        while n > 0 and n >= len(parts[0]):
            n -= len(parts[0])
            parts.pop(0)
        if n:
            head = parts[0]
            if isinstance(head, bytes):
                head = memoryview(head)
            parts[0] = head[n:]


def send_tensors(sock: socket.socket, msg_type: int, buf: TensorBuffer,
                 client_id: int = 0, seq: int = 0, pts: int = 0,
                 epoch_us: int = 0, trace_id: int = 0, span_id: int = 0,
                 origin_us: int = 0) -> None:
    """Scatter-gather DATA/REPLY send: header + count + per-tensor
    (meta, payload view) as one ``sendmsg`` iovec.  The tensor payload
    bytes are handed to the kernel straight from the source arrays —
    the serialize path's only fresh bytes are the wire header, the
    count word, and the 128-byte metas."""
    t0 = time.monotonic_ns() if annotation_active() else 0
    parts = tensor_parts(buf)
    plen = sum(len(p) if isinstance(p, bytes) else p.nbytes for p in parts)
    header = HEADER.pack(MAGIC, msg_type, client_id, seq, pts, epoch_us,
                         trace_id, span_id, origin_us,
                         _parts_crc(parts), plen)
    record_copy(len(header))   # header+metas are the copy budget
    record_copy(4 + META_HEADER_SIZE * buf.num_tensors)
    if t0:
        # framing/CRC is serialize; the sendmsg below is transfer time
        # and stays in the enclosing element span (wire)
        annotate("serialize", t0, time.monotonic_ns())
    sendmsg_all(sock, [header] + parts)


def encode_tensors(buf: TensorBuffer) -> bytes:
    """Serialize all tensors with per-tensor meta headers into one
    contiguous blob.  This MATERIALIZES every payload byte — transports
    on the hot path use :func:`tensor_parts` / :func:`send_tensors`
    instead; this stays for single-blob consumers (mqtt, files) and
    reports itself to the copy tracer."""
    parts = tensor_parts(buf)
    blob = b"".join(bytes(p) if not isinstance(p, bytes) else p
                    for p in parts)
    record_copy(len(blob))
    return blob


def decode_tensors(payload) -> List[np.ndarray]:
    """Zero-copy decode: tensors are views into ``payload`` (bytes or a
    pooled-slab memoryview).  Views are read-only — pooled payloads are
    shared (tee contract); attach the message's lease to the
    TensorBuffer that carries them.  ``writeable=False`` survives numpy
    view/reshape derivation, so downstream transform/decoder reshapes
    stay non-writable; under the sanitizer (``NNS_DEBUG=1``) a write
    attempt raises a contract-naming AliasingError instead of numpy's
    bare read-only ValueError (analysis/sanitizer.py guard_readonly)."""
    t0 = time.monotonic_ns() if annotation_active() else 0
    (n,) = struct.unpack_from("<I", payload, 0)
    off = 4
    tensors = []
    from ..analysis import sanitizer as _san
    from ..tensor.types import dim_to_np_shape

    guard = _san._ENABLED
    for _ in range(n):
        meta = TensorMetaInfo.from_bytes(payload[off:off + META_HEADER_SIZE])
        off += META_HEADER_SIZE
        size = meta.data_size
        raw = np.frombuffer(payload, np.uint8, count=size, offset=off)
        off += size
        arr = (raw.view(meta.dtype.np_dtype)
               .reshape(dim_to_np_shape(meta.dims)))
        if arr.flags.writeable:
            arr.flags.writeable = False
        if guard:
            arr = _san.guard_readonly(arr)
        tensors.append(arr)
    if t0:
        annotate("serialize", t0, time.monotonic_ns())
    return tensors


def send_msg(sock: socket.socket, msg: Message) -> None:
    sock.sendall(pack(msg))


def send_msg_zc(sock: socket.socket, msg: Message) -> None:
    """Relay a received message without flattening its payload: header
    and payload view go out as one ``sendmsg`` iovec, reusing the
    already-verified CRC (the edge broker's fan-out hot path)."""
    payload = msg.payload
    if isinstance(payload, bytes):
        sock.sendall(pack(msg))
        return
    header = HEADER.pack(MAGIC, msg.type, msg.client_id, msg.seq,
                         msg.pts, msg.epoch_us, msg.trace_id,
                         msg.span_id, msg.origin_us, msg.crc,
                         len(payload))
    sendmsg_all(sock, [header, payload])


def recv_msg(sock: socket.socket,
             pool: Optional[TensorBufferPool] = None) -> Optional[Message]:
    """Receive one message.  With ``pool``, DATA/REPLY payloads land via
    ``recv_into`` in a recycled :class:`BufferLease` slab (zero
    intermediate chunk list, zero ``b"".join``) and ``msg.payload`` is a
    memoryview with ``msg.lease`` holding the slab."""
    # the header's first byte is the only point where a socket timeout
    # is benign (idle connection on a bounded-send socket —
    # query/server.py sets one so a non-draining client cannot wedge
    # the pipeline thread in reply()); it propagates as TimeoutError
    # for the caller to retry.  Any LATER timeout is a mid-message
    # stall: the stream is desynced and the peer is treated as gone.
    hdr = _recv_exact(sock, HEADER.size, idle_ok=True)
    if hdr is None:
        return None
    (magic, typ, cid, seq, pts, epoch, trace_id, span_id, origin_us,
     crc, plen) = HEADER.unpack(hdr)
    if magic != MAGIC:
        raise ValueError(f"bad magic 0x{magic:08x}")
    if plen > MAX_WIRE_PAYLOAD:
        # sanity-bound the wire-declared length BEFORE allocating: a
        # corrupted header (chaos 'corrupt' mode / bit-flip / malicious
        # peer) must fail like a CRC mismatch, not as an up-to-4 GiB
        # upfront bytearray allocation in pool.acquire
        raise ValueError(
            f"payload length {plen} exceeds wire bound "
            f"{MAX_WIRE_PAYLOAD} (corrupt header?)")
    lease = None
    if not plen:
        payload = b""
    elif pool is not None and typ in (T_DATA, T_REPLY):
        lease = pool.acquire(plen)
        payload = lease.memory()
        if not _recv_exact_into(sock, payload):
            lease.release()
            return None
    else:
        payload = _recv_exact(sock, plen)
        if payload is None:
            return None
    if crc and plen:
        fn = _crc_fn()
        if fn is not None:
            got = fn(payload) or 1
            if got != crc:
                if lease is not None:
                    lease.release()
                raise ValueError(
                    f"payload CRC mismatch: frame seq={seq} declared "
                    f"0x{crc:08x}, computed 0x{got:08x} (corrupt stream)")
    return Message(type=typ, client_id=cid, seq=seq, pts=pts,
                   epoch_us=epoch, trace_id=trace_id, span_id=span_id,
                   origin_us=origin_us, payload=payload, lease=lease,
                   crc=crc)


def _recv_exact(sock: socket.socket, n: int,
                idle_ok: bool = False) -> Optional[bytes]:
    chunks = []
    got = 0
    while got < n:
        try:
            chunk = sock.recv(n - got)
        except socket.timeout:
            if idle_ok and not chunks:
                raise          # idle timeout before any byte: retryable
            return None        # mid-read stall: desynced zombie peer
        except (ConnectionResetError, OSError):
            return None
        if not chunk:
            return None
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _recv_exact_into(sock: socket.socket, mv: memoryview) -> bool:
    """Fill ``mv`` completely from the socket (True on success)."""
    got = 0
    n = len(mv)
    while got < n:
        try:
            k = sock.recv_into(mv[got:])
        except socket.timeout:
            return False       # mid-payload stall: desynced zombie peer
        except (ConnectionResetError, OSError):
            return False
        if not k:
            return False
        got += k
    return True
