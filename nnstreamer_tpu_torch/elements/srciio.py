"""tensor_src_iio: Linux Industrial I/O sensor source.

Parity with gst/nnstreamer/elements/gsttensor_srciio.c (struct
gsttensor_srciio.h:52-131): scans an IIO device's sysfs tree for enabled
scan-element channels, reads samples, applies per-channel scale/offset, and
emits float tensors.  The reference's test strategy — a simulated sysfs
device tree (tests/nnstreamer_source/unittest_src_iio.cc) — is mirrored by
the ``base-dir`` property pointing at any directory laid out like
``/sys/bus/iio/devices``.

Two capture modes, mirroring the reference's:

- ``mode=poll`` (one-shot role): polls the sysfs ``in_*_raw`` text values
  at the negotiated rate.
- ``mode=buffer`` (triggered/continuous role, gsttensor_srciio.c buffered
  engine): configures the trigger (``trigger/current_trigger``), enables
  the ``scan_elements`` channels (``in_*_en``), parses each channel's
  binary layout from its ``in_*_type`` spec (``le:s12/16>>4`` —
  endianness, sign, realbits/storagebits, shift), sets ``buffer/length``,
  enables the buffer, and reads packed binary sample frames from the
  device chardev with endian conversion, shift, sign-extension and
  scale/offset applied per channel.

The ``base-dir``/``dev-dir`` properties point the sysfs tree and chardev
directory at a simulated layout for tests, exactly the reference's
simulated-device-tree strategy (tests/nnstreamer_source/
unittest_src_iio.cc).  The counterpart of
``nnstreamer_tpu/elements/srciio.py`` (host code, as there).
"""

from __future__ import annotations

import os
import time
from fractions import Fraction
from typing import Dict, List, Optional

import numpy as np

from ..pipeline.caps import Caps
from ..pipeline.graph import Source
from ..pipeline.registry import register_element
from ..tensor.buffer import SECOND, TensorBuffer
from ..tensor.caps_util import caps_from_config, static_tensors_caps
from ..tensor.info import TensorInfo, TensorsConfig, TensorsInfo
from ..tensor.types import TensorType

DEFAULT_BASE_DIR = "/sys/bus/iio/devices"


def parse_type_spec(spec: str) -> Dict:
    """Parse an IIO scan-element type spec like ``le:s12/16>>4`` into
    (endian, signed, realbits, storagebits, shift) — the reference's
    gst_tensor_src_iio_get_channel_type parsing."""
    endian, _, rest = spec.strip().partition(":")
    if endian not in ("le", "be"):
        raise ValueError(f"iio: bad type spec {spec!r} (endian)")
    signed = rest[:1]
    if signed not in ("s", "u"):
        raise ValueError(f"iio: bad type spec {spec!r} (sign)")
    bits_part, _, shift_part = rest[1:].partition(">>")
    real_s, _, storage_s = bits_part.partition("/")
    real = int(real_s)
    storage = int(storage_s or real_s)
    if storage not in (8, 16, 32, 64):
        raise ValueError(f"iio: unsupported storagebits {storage}")
    if real > storage:
        raise ValueError(f"iio: realbits {real} > storagebits {storage}")
    return {"endian": endian, "signed": signed == "s", "realbits": real,
            "storagebits": storage,
            "shift": int(shift_part) if shift_part else 0}


def extract_sample(raw: int, spec: Dict) -> int:
    """Shift + mask + sign-extend one storage word (reference
    gst_tensor_src_iio_process_scanned_data)."""
    v = (raw >> spec["shift"]) & ((1 << spec["realbits"]) - 1)
    if spec["signed"] and v & (1 << (spec["realbits"] - 1)):
        v -= 1 << spec["realbits"]
    return v


@register_element
class TensorSrcIIO(Source):
    FACTORY = "tensor_src_iio"
    PROPERTIES = {
        "device": (None, "IIO device name (matches <dev>/name)"),
        "device-number": (-1, "or explicit iio:deviceN number"),
        "base-dir": (DEFAULT_BASE_DIR, "sysfs root (tests point this at a "
                                       "simulated tree)"),
        "dev-dir": ("/dev", "chardev directory for mode=buffer (tests "
                            "point this at a simulated one)"),
        "mode": ("poll", "poll (sysfs one-shot) | buffer (triggered "
                         "chardev capture)"),
        "trigger": (None, "trigger name to write to current_trigger "
                          "(mode=buffer)"),
        "buffer-capacity": (1, "samples per emitted tensor AND the value "
                               "written to buffer/length (mode=buffer)"),
        "frequency": (10, "sampling frequency Hz"),
        "num-buffers": (-1, "samples to emit, -1 unlimited"),
        "merge-channels": (True, "one tensor of all channels vs per-channel"),
    }

    def _make_pads(self):
        self.add_src_pad(static_tensors_caps(), "src")

    def start(self):
        base = str(self.base_dir)
        self._dev_dir = self._find_device(base)
        self._count = 0
        self._pace_origin_ns = None   # first-sample monotonic anchor
        self._chardev = None
        if str(self.mode) == "buffer":
            self._channels = self._scan_buffer_channels(self._dev_dir)
            if not self._channels:
                raise ValueError(
                    f"{self.name}: no scan_elements in {self._dev_dir}")
            self._setup_buffer_capture()
        else:
            self._channels = self._scan_channels(self._dev_dir)
            if not self._channels:
                raise ValueError(
                    f"{self.name}: no channels in {self._dev_dir}")

    def stop(self):
        if self._chardev is not None:
            try:
                self._chardev.close()
            except OSError:
                pass
            self._chardev = None
            # disable the buffer on teardown (reference stop path)
            self._write_sysfs(os.path.join(self._dev_dir, "buffer",
                                           "enable"), "0")
        super().stop()

    def _find_device(self, base: str) -> str:
        if not os.path.isdir(base):
            raise ValueError(f"{self.name}: no IIO tree at {base}")
        want_num = int(self.device_number)
        want_name = self.device
        for entry in sorted(os.listdir(base)):
            if not entry.startswith("iio:device"):
                continue
            path = os.path.join(base, entry)
            if want_num >= 0 and entry == f"iio:device{want_num}":
                return path
            if want_name:
                name_file = os.path.join(path, "name")
                if os.path.exists(name_file):
                    with open(name_file) as f:
                        if f.read().strip() == str(want_name):
                            return path
        raise ValueError(
            f"{self.name}: device {want_name or want_num!r} not found "
            f"under {base}")

    def _scan_channels(self, dev_dir: str) -> List[Dict]:
        """Channels = in_*_raw files, with optional *_scale / *_offset
        (reference channel scan over scan_elements)."""
        chans = []
        for fname in sorted(os.listdir(dev_dir)):
            if fname.startswith("in_") and fname.endswith("_raw"):
                stem = fname[:-4]  # in_voltage0
                chans.append({
                    "name": stem,
                    "raw": os.path.join(dev_dir, fname),
                    "scale": self._read_float(
                        os.path.join(dev_dir, stem + "_scale"), 1.0),
                    "offset": self._read_float(
                        os.path.join(dev_dir, stem + "_offset"), 0.0),
                })
        return chans

    @staticmethod
    def _read_float(path: str, default: float) -> float:
        """Missing file → default (IIO semantics: absent *_scale means raw
        units).  A PRESENT but malformed file is a broken device tree —
        warn instead of silently normalizing with the default."""
        try:
            with open(path) as f:
                text = f.read().strip()
        except OSError:
            return default
        try:
            return float(text)
        except ValueError:
            from ..utils.log import ml_logw

            ml_logw("srciio: malformed sysfs float %s=%r; using %s",
                    path, text, default)
            return default

    def _write_sysfs(self, path: str, value: str) -> bool:
        """Write a sysfs control file; missing files are reported (the
        round-1 silent-fallback gap), not fatal — simulated trees may omit
        controls the real kernel always has."""
        try:
            with open(path, "w") as f:
                f.write(value)
            return True
        except OSError as e:
            from ..utils.log import logger

            logger.warning("%s: cannot write %s=%s: %s", self.name, path,
                           value, e)
            return False

    # -- buffered/triggered capture (reference gsttensor_srciio.c engine) ----
    def _scan_buffer_channels(self, dev_dir: str) -> List[Dict]:
        """Scan ``scan_elements``: per channel the _type layout spec,
        _index byte order, and _en enable switch (which we turn on, like
        the reference's channel-enable writes)."""
        se_dir = os.path.join(dev_dir, "scan_elements")
        if not os.path.isdir(se_dir):
            raise ValueError(f"{self.name}: mode=buffer but no "
                             f"scan_elements dir in {dev_dir}")
        chans = []
        for fname in sorted(os.listdir(se_dir)):
            if not fname.endswith("_type") or not fname.startswith("in_"):
                continue
            stem = fname[:-5]                       # in_voltage0
            with open(os.path.join(se_dir, fname)) as f:
                spec = parse_type_spec(f.read())
            idx_path = os.path.join(se_dir, stem + "_index")
            try:
                with open(idx_path) as f:
                    index = int(f.read().strip())
            except (OSError, ValueError):
                index = len(chans)
            chans.append({
                "name": stem, "spec": spec, "index": index,
                "en": os.path.join(se_dir, stem + "_en"),
                "scale": self._read_float(
                    os.path.join(dev_dir, stem + "_scale"), 1.0),
                "offset": self._read_float(
                    os.path.join(dev_dir, stem + "_offset"), 0.0),
            })
        chans.sort(key=lambda c: c["index"])
        return chans

    def _setup_buffer_capture(self) -> None:
        # 1. enable every scan channel (reference enables the channel set)
        for c in self._channels:
            self._write_sysfs(c["en"], "1")
        # 2. configure the trigger when given
        if self.trigger:
            self._write_sysfs(
                os.path.join(self._dev_dir, "trigger", "current_trigger"),
                str(self.trigger))
        # 3. buffer length then enable (reference ordering)
        cap = max(int(self.buffer_capacity), 1)
        self._write_sysfs(os.path.join(self._dev_dir, "buffer", "length"),
                          str(cap))
        self._write_sysfs(os.path.join(self._dev_dir, "buffer", "enable"),
                          "1")
        # 4. open the chardev — on failure disable the buffer again so the
        # kernel is not left capturing (a retry would then hit EBUSY on
        # the channel-enable writes)
        dev_name = os.path.basename(self._dev_dir)
        path = os.path.join(str(self.dev_dir), dev_name)
        try:
            self._chardev = open(path, "rb", buffering=0)
        except OSError as e:
            self._write_sysfs(os.path.join(self._dev_dir, "buffer",
                                           "enable"), "0")
            raise ValueError(f"{self.name}: cannot open chardev {path}: "
                             f"{e}") from e
        # packed frame layout: channels at storage-size alignment, in
        # index order (reference scan-element frame geometry)
        off = 0
        for c in self._channels:
            size = c["spec"]["storagebits"] // 8
            off = (off + size - 1) // size * size   # natural alignment
            c["byte_off"] = off
            off += size
        self._frame_bytes = off

    def _read_exact(self, n: int) -> Optional[bytes]:
        out = b""
        while len(out) < n and not self._halted.is_set():
            chunk = self._chardev.read(n - len(out))
            if not chunk:
                return out if out else None
            out += chunk
        return out if len(out) == n else None

    def _create_buffered(self) -> Optional[np.ndarray]:
        """Read buffer-capacity packed frames from the chardev and decode
        to a (capacity, channels) float array."""
        cap = max(int(self.buffer_capacity), 1)
        blob = self._read_exact(self._frame_bytes * cap)
        if blob is None:
            return None
        cap = len(blob) // self._frame_bytes
        if cap == 0:
            return None
        mat8 = np.frombuffer(blob[:cap * self._frame_bytes],
                             np.uint8).reshape(cap, self._frame_bytes)
        out = np.empty((cap, len(self._channels)), np.float32)
        for j, c in enumerate(self._channels):
            spec = c["spec"]
            size = spec["storagebits"] // 8
            dt = np.dtype(f"{'<' if spec['endian'] == 'le' else '>'}u{size}")
            words = mat8[:, c["byte_off"]:c["byte_off"] + size] \
                .copy().view(dt).reshape(-1).astype(np.int64)
            v = (words >> spec["shift"]) & ((1 << spec["realbits"]) - 1)
            if spec["signed"]:
                sign_bit = 1 << (spec["realbits"] - 1)
                v = np.where(v & sign_bit, v - (1 << spec["realbits"]), v)
            out[:, j] = (v + c["offset"]) * c["scale"]
        return out

    def negotiate(self) -> Caps:
        n = len(self._channels)
        buffered = str(self.mode) == "buffer"
        cap = max(int(self.buffer_capacity), 1) if buffered else 1
        # caps rate is the BUFFER cadence: capacity samples coalesce into
        # one buffer, so downstream sees frequency/capacity frames per sec
        rate = Fraction(int(self.frequency), cap)
        if bool(self.merge_channels):
            # innermost-first dims: (channels, capacity) numpy shape →
            # reference dim string channels:capacity
            shape = (cap, n) if cap > 1 else (n,)
            info = TensorsInfo([TensorInfo(TensorType.FLOAT32, shape)])
        else:
            shape = (cap, 1) if cap > 1 else (1,)
            info = TensorsInfo([TensorInfo(TensorType.FLOAT32, shape,
                                           name=c["name"])
                                for c in self._channels])
        self._config = TensorsConfig(info=info, rate=rate)
        return caps_from_config(self._config)

    def create(self) -> Optional[TensorBuffer]:
        limit = int(self.num_buffers)
        if limit >= 0 and self._count >= limit:
            return None
        freq = max(int(self.frequency), 1)
        if str(self.mode) == "buffer":
            mat = self._create_buffered()     # (capacity, channels)
            if mat is None:
                return None
            cap = max(int(self.buffer_capacity), 1)
            if mat.shape[0] < cap:            # short final read: pad-free EOS
                return None
            if cap == 1:
                mat = mat[0]
            if bool(self.merge_channels):
                tensors = [mat]
            else:
                tensors = [mat[..., i:i + 1] for i in
                           range(len(self._channels))]
            pts = self._count * cap * SECOND // freq
            buf = TensorBuffer(tensors=tensors, pts=pts,
                               duration=cap * SECOND // freq)
            self._count += 1
            return buf
        values = []
        for c in self._channels:
            raw = self._read_float(c["raw"], 0.0)
            values.append((raw + c["offset"]) * c["scale"])
        arr = np.asarray(values, np.float32)
        pts = self._count * SECOND // freq
        if bool(self.merge_channels):
            tensors = [arr]
        else:
            tensors = [arr[i:i + 1] for i in range(len(values))]
        buf = TensorBuffer(tensors=tensors, pts=pts,
                           duration=SECOND // freq)
        self._count += 1
        # pace to the requested frequency against an ABSOLUTE monotonic
        # deadline ladder: relative time.sleep(1/freq) drifts by the
        # per-sample processing time (so rate metrics read low), and a
        # plain sleep is uncancellable — the event wait returns the
        # moment stop() sets _halted, and a late sample shortens the
        # next wait instead of pushing every later deadline out
        if (limit < 0 or self._count < limit) and freq < 1000:
            if self._pace_origin_ns is None:
                self._pace_origin_ns = time.monotonic_ns()
            deadline_ns = (self._pace_origin_ns
                           + self._count * SECOND // freq)
            wait_s = (deadline_ns - time.monotonic_ns()) / 1e9
            if wait_s > 0:
                self._halted.wait(wait_s)
        return buf
