"""NTP wall-clock utilities for cross-device timestamp alignment.

Parity with the reference's NTP support (gst/mqtt/ntputil.c: SNTPv4 query,
xmit-timestamp → unix epoch µs, ``pool.ntp.org:123`` default) used by its
MQTT elements to embed a shared epoch so PTS from different devices can be
aligned (Documentation/synchronization-in-mqtt-elements.md).  The network
call is injectable (``_query``) so tests run hermetically — the reference
gmocks ``ntohl``/``recvfrom`` the same way
(tests/gstreamer_mqtt/unittest_ntp_util_mock.cc).

The port of ``nnstreamer_tpu/utils/ntp.py``, unchanged but for its logger.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Callable, Optional, Sequence

#: seconds between the NTP era (1900) and the unix epoch (1970)
NTP_TIMESTAMP_DELTA = 2_208_988_800
_FRAC_PER_SEC = 1 << 32

DEFAULT_HOSTS = ("pool.ntp.org",)
DEFAULT_PORT = 123


class NTPError(OSError):
    pass


def _udp_query(host: str, port: int, packet: bytes, timeout: float) -> bytes:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.settimeout(timeout)
        s.sendto(packet, (host, port))
        data, _ = s.recvfrom(512)
    return data


def parse_xmit_epoch_us(response: bytes) -> int:
    """Transmit-timestamp (offset 40: u32 sec, u32 frac, big endian) →
    unix-epoch microseconds (reference ntputil.c conversion)."""
    if len(response) < 48:
        raise NTPError(f"short NTP response ({len(response)} bytes)")
    sec, frac = struct.unpack_from(">II", response, 40)
    if sec == 0:
        raise NTPError("NTP response has zero transmit timestamp")
    usec = (sec - NTP_TIMESTAMP_DELTA) * 1_000_000 \
        + (frac * 1_000_000) // _FRAC_PER_SEC
    return usec


def get_epoch_us(hosts: Optional[Sequence[str]] = None,
                 ports: Optional[Sequence[int]] = None,
                 timeout: float = 3.0,
                 _query: Optional[Callable[[str, int, bytes, float],
                                           bytes]] = None) -> int:
    """Query the first answering NTP server for the current unix epoch (µs).

    Reference: ``ntputil_get_epoch`` — iterates (host, port) pairs, SNTPv4
    client packet (LI=0 VN=4 mode=3), returns xmit timestamp.
    """
    hosts = list(hosts or DEFAULT_HOSTS)
    ports = list(ports or [DEFAULT_PORT] * len(hosts))
    query = _query or _udp_query
    packet = bytearray(48)
    packet[0] = 0x23                      # LI=0, VN=4, mode=3 (client)
    err: Optional[Exception] = None
    for host, port in zip(hosts, ports):
        try:
            return parse_xmit_epoch_us(query(host, port, bytes(packet),
                                             timeout))
        except (OSError, struct.error) as e:
            err = e
    raise NTPError(f"no NTP server reachable: {err}")


class WallClockSync:
    """Cached NTP↔local offset; falls back to the local clock when no
    server answers (the reference's ``g_get_real_time`` fallback).

    ``now_us()`` is the NTP-aligned wall clock; ``synced`` says whether an
    NTP server actually contributed.  Offset refreshes lazily every
    ``refresh_s`` (the caching the reference marks @todo).
    """

    def __init__(self, hosts: Optional[Sequence[str]] = None,
                 ports: Optional[Sequence[int]] = None,
                 refresh_s: float = 300.0,
                 _query=None, _local_us: Optional[Callable[[], int]] = None):
        self._hosts, self._ports = hosts, ports
        self._refresh_s = refresh_s
        self._query = _query
        self._local_us = _local_us or (lambda: time.time_ns() // 1000)
        self._offset_us = 0
        self._synced = False
        self._last_sync = float("-inf")
        self._lock = threading.Lock()

    @property
    def synced(self) -> bool:
        return self._synced

    def _maybe_refresh(self) -> None:
        now = time.monotonic()
        if now - self._last_sync < self._refresh_s:
            return
        self._last_sync = now
        try:
            ntp = get_epoch_us(self._hosts, self._ports, _query=self._query)
            self._offset_us = ntp - self._local_us()
            self._synced = True
        except NTPError:
            # keep the last-known-good offset on a transient re-query
            # failure — zeroing it would jump now_us() mid-stream
            if not self._synced:
                self._offset_us = 0

    def offset_us(self) -> int:
        with self._lock:
            self._maybe_refresh()
            return self._offset_us

    def now_us(self) -> int:
        with self._lock:
            self._maybe_refresh()
            return self._local_us() + self._offset_us


def stream_origin_epoch_us(ntp_host, element_name: str = "edge") -> int:
    """Stream-origin wall-clock epoch (µs) for edge elements.

    Shared by edge_sink/edge_src start(): parses the ``ntp-host`` property
    (comma-separated servers, None → local clock), queries via
    :class:`WallClockSync`, and — when NTP was explicitly requested but no
    server answered — warns loudly instead of silently using the local
    clock, since unaligned epochs corrupt cross-device PTS re-basing.
    """
    from .log import logger

    if not ntp_host:
        return time.time_ns() // 1000
    hosts = [h.strip() for h in str(ntp_host).split(",") if h.strip()]
    if not hosts:
        # degenerate value like "," — local clock, NOT the default public
        # pool (get_epoch_us would substitute DEFAULT_HOSTS for [])
        return time.time_ns() // 1000
    sync = WallClockSync(hosts=hosts)
    epoch = sync.now_us()
    if not sync.synced:
        logger.warning("%s: ntp-host=%s set but no NTP server answered — "
                "falling back to the LOCAL clock; cross-device PTS "
                "alignment will be off by this host's clock error",
                element_name, ntp_host)
    return epoch
