"""Client half of the token-streaming reply contract.

The PyTorch counterpart of ``nnstreamer_tpu/llm/client.py`` (the same
code over the port's query plane; it speaks the same wire, so either
package's client talks to either package's ``tensor_llm`` server).

The query wire protocol is UNCHANGED: a token-stream request is one
ordinary ``T_DATA`` frame, and the answer is MANY ``T_REPLY`` frames
sharing the request's seq — each carrying one ``[1, 1] int32`` token
with ``pts`` = token index.  The stream ends by the stop-token
contract: after ``max_new`` frames, or earlier at the first frame whose
token equals the request's ``stop_token`` (that frame is delivered and
IS the end marker); a NEGATIVE token is unconditionally terminal (the
server's refusal/eviction markers — real vocab tokens are never
negative).  ``T_SHED`` for the seq surfaces as
:class:`~nnstreamer_tpu_torch.query.overload.ShedError` exactly like the
request/response path — slot exhaustion is an explicit, retryable
refusal.

Built over :class:`~nnstreamer_tpu_torch.query.client.QueryConnection`'s
transport internals (socket, reader thread, reply queue, seq
allocation) so HELLO/QoS negotiation, clock-offset sampling and the
T_TRACE piggyback all apply unchanged.  One outstanding stream per
connection (the synchronous QueryConnection discipline).
"""

from __future__ import annotations

import queue as _queue
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..query.client import QueryConnection
from ..query.overload import ShedError
from ..query.protocol import (T_DATA, T_REPLY, T_SHED, decode_tensors,
                              parse_retry_after, send_tensors)
from ..tensor.buffer import TensorBuffer
from .element import REQ_HEADER


class TokenTimeoutError(TimeoutError):
    """The next token missed the per-token inactivity deadline.

    Raised by :meth:`TokenStreamClient.stream` with the undelivered
    reply queue already DRAINED (leased wire slabs released): the
    caller sees a named, catchable verdict and the slab pool sees its
    memory back immediately — an abandoned stream must not hold pooled
    slabs hostage until garbage collection.
    """

    def __init__(self, msg: str, got: int = 0,
                 timeout_s: float = 0.0) -> None:
        super().__init__(msg)
        self.got = got               # tokens delivered before the stall
        self.timeout_s = timeout_s   # the deadline that fired


def encode_request(prompt: Sequence[int], max_new: int,
                   stop_token: int = -1,
                   frame_len: Optional[int] = None) -> np.ndarray:
    """The ``tensor_llm`` request framing: ``(N,) int32`` =
    ``[prompt_len, max_new, stop_token, prompt...]``, zero-padded to
    ``frame_len`` (the serving caps' fixed tensor length)."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    n = REQ_HEADER + prompt.shape[0]
    total = int(frame_len) if frame_len else n
    if total < n:
        raise ValueError(f"frame_len={frame_len} cannot hold a "
                         f"{prompt.shape[0]}-token prompt")
    out = np.zeros((total,), np.int32)
    out[0] = prompt.shape[0]
    out[1] = int(max_new)
    out[2] = int(stop_token)
    out[REQ_HEADER:n] = prompt
    return out


class TokenStreamClient:
    """One token-streaming connection to a ``tensor_llm`` server."""

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 qos: Optional[str] = None,
                 model: Optional[str] = None,
                 token_timeout: Optional[float] = None) -> None:
        self._conn = QueryConnection(host, port, timeout=timeout,
                                     qos=qos, model=model)
        self.timeout = float(timeout)
        #: per-token inactivity deadline (seconds) — how long a stream
        #: may go WITHOUT a next token before it is declared stalled
        #: (:class:`TokenTimeoutError`); ``None`` inherits the
        #: transport timeout, but a serving caller should set it from
        #: its own latency budget: the transport default is a connect/
        #: request deadline and says nothing about inter-token gaps
        self.token_timeout = (float(token_timeout)
                              if token_timeout is not None
                              else self.timeout)
        #: per-token receive stamps (``mono_ns``) of the CURRENT /
        #: most recent stream, reset at each :meth:`stream` send — the
        #: wire-side half of the token-latency contract: the loadgen
        #: measures coordinated-omission-free TTFT as ``stamps_ns[0] -
        #: scheduled arrival`` and ITL from consecutive stamps, so a
        #: stalled server cannot hide behind a late send
        self.stamps_ns: List[int] = []

    def connect(self) -> "TokenStreamClient":
        self._conn.connect()
        return self

    def close(self) -> None:
        self._conn.close()
        self._drain_replies()

    def _drain_replies(self) -> None:
        """Release every undelivered reply's leased wire slab: a
        stream abandoned mid-flight (disconnect, shed, stall, caller
        bailed) leaves leased token frames queued — their pooled slabs
        must return to the pool NOW, not whenever the queue object
        happens to be collected."""
        while True:
            try:
                msg = self._conn.replies.get_nowait()
            except _queue.Empty:
                break
            if msg is not None and msg.lease is not None:
                msg.payload = b""
                msg.lease.release()

    @property
    def connection(self) -> QueryConnection:
        return self._conn

    def stream(self, prompt: Sequence[int], max_new: int,
               stop_token: int = -1,
               frame_len: Optional[int] = None,
               token_timeout: Optional[float] = None
               ) -> Iterator[Tuple[int, int]]:
        """Send one request; yield ``(index, token)`` pairs as reply
        frames arrive, ending by the stop-token contract.  Raises
        :class:`ShedError` on an explicit slot shed,
        :class:`TokenTimeoutError` when the next token misses the
        per-token inactivity deadline (``token_timeout`` here, the
        client's ``token_timeout`` otherwise — raised with the reply
        queue drained and its leased slabs released), and
        ``ValueError`` on an out-of-order token index (the exact
        per-client order gate — ``pts`` must count 0, 1, 2, …)."""
        conn = self._conn
        gap = (float(token_timeout) if token_timeout is not None
               else self.token_timeout)
        req = encode_request(prompt, max_new, stop_token, frame_len)
        from ..obs.clock import mono_ns

        self.stamps_ns = stamps = []
        with conn._waiters_lock:
            conn._seq += 1
            seq = conn._seq
        with conn._send_lock:
            send_tensors(conn._sock, T_DATA,
                         TensorBuffer(tensors=[req]), seq=seq)
        got = 0
        while got < max_new:
            deadline = time.monotonic() + gap
            reply = None
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._drain_replies()
                    raise TokenTimeoutError(
                        f"no token within {gap}s "
                        f"(received {got}/{max_new})",
                        got=got, timeout_s=gap)
                try:
                    reply = conn.replies.get(timeout=remaining)
                except _queue.Empty:
                    continue
                if reply is None:
                    raise ConnectionError(
                        "server closed connection mid-stream")
                if reply.seq == seq:
                    break
                # stale reply of an earlier timed-out request: discard
            if reply.type == T_SHED:
                raise ShedError(parse_retry_after(reply.payload),
                                qos=conn.qos or "default")
            assert reply.type == T_REPLY
            tok = int(np.asarray(decode_tensors(
                reply.payload)[0]).reshape(-1)[0])
            idx = int(reply.pts or 0)
            if idx != got:
                raise ValueError(
                    f"token order violated: expected index {got}, "
                    f"got {idx}")
            got += 1
            stamps.append(mono_ns())
            yield idx, tok
            if tok < 0 or (stop_token >= 0 and tok == stop_token):
                # a NEGATIVE token is unconditionally terminal: real
                # vocab tokens are >= 0, so the element's refusal /
                # eviction markers (emitted as the request's stop_token,
                # -1 when none was set) must end the stream even for
                # callers that set no stop token — without this the
                # "deterministic refusal" would read as a hang until
                # the per-token timeout
                return

    def generate(self, prompt: Sequence[int], max_new: int,
                 stop_token: int = -1,
                 frame_len: Optional[int] = None) -> List[int]:
        """Collect a whole stream (order-checked by :meth:`stream`)."""
        return [tok for _, tok in self.stream(prompt, max_new,
                                              stop_token, frame_len)]
