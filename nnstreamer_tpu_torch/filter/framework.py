"""Filter framework ABI: the contract every inference backend implements.

The PyTorch port of the JAX package's redesign of
``GstTensorFilterFramework`` v1 (reference:
gst/nnstreamer/include/nnstreamer_plugin_api_filter.h:273-495) and the
shared open/close/detect logic of tensor_filter_common.c.  The C vtable with
magic+version becomes a Python ABC; ``__attribute__((constructor))``
self-registration becomes :func:`register_filter`; dlopen'd .so discovery
becomes import of :mod:`nnstreamer_tpu_torch.filter.backends`.

Kept 1:1 in spirit:

- open/close lifecycle with :class:`FilterProperties` (model, forced io
  info, accelerator string, custom properties — reference props struct
  nnstreamer_plugin_api_filter.h:139-164)
- getModelInfo (in/out :class:`TensorsInfo`) and SET_INPUT_INFO
  renegotiation
- eventHandler (RELOAD_MODEL / CUSTOM_PROP / SET_ACCELERATOR — reference
  events :201-262)
- ``framework=auto`` detection by model kind + priority list (reference
  tensor_filter_common.c:1208-1345)
- the shared-model table (``shared_tensor_filter_key``, reference
  :2910-3045)
- per-instance latency/throughput statistics (reference
  tensor_filter_common.h:77-91)
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

from ..tensor.info import TensorsInfo


class Accelerator(enum.Enum):
    """Hardware targets for accelerator negotiation.

    Reference: ``accl_hw`` enum nnstreamer_plugin_api_filter.h:80-102 (NEON/
    NPU variants collapse into the targets that exist on a GPU host).
    ``GPU`` is the reference's ``ACCL_GPU`` entry and the first-class
    device target; it takes the place of the JAX package's ``TPU``.
    """

    NONE = "none"
    DEFAULT = "default"
    AUTO = "auto"
    CPU = "cpu"
    GPU = "gpu"

    @classmethod
    def parse(cls, accl_str: Optional[str]) -> List["Accelerator"]:
        """Parse the ``accelerator`` property: ``"true:gpu,cpu"`` picks the
        listed targets in order, ``"false"`` disables acceleration.

        Reference: gst_tensor_filter_parse_accelerator
        (tensor_filter_common.c:2494-2800).
        """
        if not accl_str:
            return [cls.AUTO]
        s = accl_str.strip().lower()
        enabled, _, rest = s.partition(":")
        if enabled in ("false", "0", "no"):
            return [cls.NONE]
        if not rest:
            return [cls.AUTO]
        out: List[Accelerator] = []
        for tok in rest.replace(",", " ").split():
            try:
                out.append(cls(tok))
            except ValueError:
                continue  # unknown accelerators are skipped, like the ref regex
        return out or [cls.AUTO]


@dataclasses.dataclass
class FilterProperties:
    """Open-time properties handed to a backend.

    Reference: ``GstTensorFilterProperties`` nnstreamer_plugin_api_filter.h:
    139-164.  ``model`` may be a name in the model registry, a file path, or
    a Python callable (custom filters).
    """

    framework: Optional[str] = None
    model: Any = None
    input_info: Optional[TensorsInfo] = None   # forced input meta
    output_info: Optional[TensorsInfo] = None  # forced output meta
    accelerators: List[Accelerator] = dataclasses.field(
        default_factory=lambda: [Accelerator.AUTO])
    custom_properties: Dict[str, str] = dataclasses.field(default_factory=dict)
    shared_key: Optional[str] = None

    @staticmethod
    def parse_custom(custom: Optional[str]) -> Dict[str, str]:
        """``"key:value,key2:value2"`` custom-property string (reference
        custom_properties field semantics)."""
        out: Dict[str, str] = {}
        if not custom:
            return out
        for part in str(custom).split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition(":")
            out[k.strip()] = v.strip()
        return out


class FilterError(RuntimeError):
    pass


class FilterFramework:
    """Backend ABI.  Subclass per backend; register with
    :func:`register_filter`.

    Contract (mirrors the v1 vtable):

    - :meth:`open` loads/compiles the model; idempotent close via
      :meth:`close`.
    - :meth:`get_model_info` returns (input TensorsInfo, output TensorsInfo).
    - :meth:`set_input_info` optionally renegotiates for flexible inputs
      (reference GET/SET_INPUT_INFO), returning the new (in, out) infos.
    - :meth:`invoke` maps N input arrays → M output arrays.  Inputs arrive
      as numpy arrays or torch tensors in *numpy shape* order; outputs
      likewise.  Device backends return **CUDA tensors without syncing**
      so the pipeline stays async (the reference's zero-copy +
      allocate-in-invoke discipline, tensor_filter.c:737-779).
    - :meth:`handle_event` receives RELOAD_MODEL / CUSTOM_PROP / etc.
    """

    #: registry name, e.g. "xla" (reference fw name, resolved by
    #: nnstreamer_filter_find)
    NAME: str = ""
    #: hardware this backend can run on, best first
    SUPPORTED_ACCELERATORS: Sequence[Accelerator] = (Accelerator.CPU,)
    #: True when :meth:`invoke_batched` coalesces frames into one device
    #: dispatch (tensor_filter's ``batch`` property gates on this)
    SUPPORTS_BATCHING: bool = False
    #: True when :meth:`invoke` may be called from multiple threads on ONE
    #: instance (tensor_filter's ``workers`` property then shares the
    #: backend: graphs and device weights exist once).  False (default)
    #: makes ``workers=N`` open one backend instance per worker instead.
    THREADSAFE_INVOKE: bool = False

    def __init__(self) -> None:
        self.props: Optional[FilterProperties] = None
        self._opened = False

    # -- lifecycle -----------------------------------------------------------
    def open(self, props: FilterProperties) -> None:
        self.props = props
        self._opened = True

    def close(self) -> None:
        self._opened = False

    @property
    def opened(self) -> bool:
        return self._opened

    # -- model meta ----------------------------------------------------------
    def get_model_info(self) -> Tuple[TensorsInfo, TensorsInfo]:
        raise NotImplementedError

    def set_input_info(self, in_info: TensorsInfo) -> Tuple[TensorsInfo, TensorsInfo]:
        raise FilterError(f"{self.NAME}: dynamic input reconfiguration "
                          "not supported")

    # -- hot path ------------------------------------------------------------
    def invoke(self, inputs: List[Any]) -> List[Any]:
        raise NotImplementedError

    def invoke_batched(self, frames: List[List[Any]], bucket: int,
                       emit_device: bool = False):
        """Dispatch ONE device invocation covering ``len(frames)`` frames
        (each a per-frame input list), padded up to the fixed ``bucket``
        batch size so steady state uses a single executable.

        Returns a handle with ``wait() -> List[List[np.ndarray]]`` (one
        output list per input frame, padding sliced away) and ``views()``
        (``emit_device=True``: device-resident per-frame payloads, no
        device→host copy started — cascade mode).  The dispatch itself
        must not block on device completion: tensor_filter only
        ``wait()``s a batch after the NEXT one has been dispatched, so the
        copies in, the compute and the copies out of consecutive batches
        overlap."""
        raise FilterError(f"{self.NAME}: batched invoke not supported")

    def warmup_batched(self, bucket: int) -> None:
        """Compile the batched executable for ``bucket`` (and the
        per-frame one its tiny flush tails ride) so frame 1 of the stream
        is steady state."""

    def set_postprocess(self, fn) -> bool:
        """Compose a reduction ``fn(outputs) -> outputs`` into the
        backend's forward (reduction pushdown: a downstream decoder asks
        the filter to shrink outputs ON DEVICE before the host fetch —
        no reference counterpart).
        Return False when the backend cannot compose device functions."""
        return False

    def has_postprocess(self) -> bool:
        """Does this backend CURRENTLY carry a fused set_postprocess
        reduction?  The element consults this before re-applying a
        stored fusion after a model reload — set_postprocess composes
        over the forward fn, so fusing a backend that kept its fusion
        (e.g. a params-only hot swap) would apply the reduction twice."""
        return False

    # -- events --------------------------------------------------------------
    def handle_event(self, name: str, data: Optional[Dict[str, Any]] = None) -> None:
        """RELOAD_MODEL / CUSTOM_PROP / SET_ACCELERATOR (reference
        eventHandler, nnstreamer_plugin_api_filter.h:201-262).

        The default RELOAD_MODEL rebuilds the backend from a new model
        path by close+open (the reference reload-by-replace contract,
        tests/nnstreamer_filter_reload; the new model must keep the same
        tensor interface).  The element drains in-flight batches before
        delivering the event, and chain/event delivery is serialized per
        sink pad, so no invoke observes a half-swapped backend.  Backends
        with a cheaper hot path may override this."""
        if name == "reload_model":
            new_model = (data or {}).get("model")
            if not new_model:
                raise FilterError(
                    f"{self.NAME}: reload_model needs data={{'model': path}}")
            if self.props is not None and self.props.shared_key:
                # a close/open swap under a shared backend would yank the
                # model from every other element sharing it mid-invoke
                raise FilterError(
                    f"{self.NAME}: reload of a shared-tensor-filter-key "
                    "backend is not supported by the generic path")
            old = self.props
            old_info = self.get_model_info()
            # non-model event keys ride into custom properties (the
            # reference's RELOAD_MODEL carries the full new prop set);
            # a model-NAME change drops a stale `checkpoint` unless the
            # event supplies a new one — the old model's checkpoint
            # applied to the new model's params is a shape-mismatch
            # rollback at best and a silent wrong-weights load at worst
            custom = dict(old.custom_properties)
            extra = {k: str(v) for k, v in (data or {}).items()
                     if k != "model"}
            if str(new_model) != str(old.model) and "checkpoint" not in extra:
                custom.pop("checkpoint", None)
            custom.update(extra)
            props = dataclasses.replace(old, model=new_model,
                                        custom_properties=custom)

            def rollback(cause: Exception):
                try:
                    self.open(old)
                except Exception as exc:  # noqa: BLE001
                    raise FilterError(
                        f"{self.NAME}: reload failed ({cause}) AND the "
                        f"previous model could not be restored ({exc}); "
                        "backend is closed") from cause

            self.close()
            try:
                self.open(props)
            except Exception as exc:  # noqa: BLE001
                # restore the previous model: reload must not kill the
                # stream on a bad replacement (reference keeps the old)
                rollback(exc)
                raise
            new_in, new_out = self.get_model_info()
            if not new_in.is_equal(old_info[0]) or \
                    not new_out.is_equal(old_info[1]):
                self.close()
                err = FilterError(
                    f"{self.NAME}: reload model changes the tensor "
                    "interface (reference requires identical io)")
                rollback(err)
                raise err

    @classmethod
    def check_availability(cls, accelerators: Sequence[Accelerator]) -> bool:
        """Can this backend serve one of the requested accelerators?
        (reference checkAvailability)"""
        for a in accelerators:
            if a in (Accelerator.AUTO, Accelerator.DEFAULT, Accelerator.NONE):
                return True
            if a in cls.SUPPORTED_ACCELERATORS:
                return True
        return False

    @classmethod
    def handles_model(cls, model: Any) -> bool:
        """Auto-detect hook: does this backend recognize ``model``?
        (reference detects by filename extension,
        tensor_filter_common.c:1208-1345)"""
        return False


# ---------------------------------------------------------------------------
# registry (reference: nnstreamer_filter_probe/exit/find + subplugin table)
# ---------------------------------------------------------------------------

_FILTERS: Dict[str, Type[FilterFramework]] = {}

#: auto-detect priority, mirrors ini ``framework_priority_*``
#: (reference nnstreamer_conf.c framework_priority handling)
_AUTO_PRIORITY: List[str] = ["xla", "tensorflow-lite", "python", "custom"]


def register_filter(cls: Type[FilterFramework]) -> Type[FilterFramework]:
    if not cls.NAME:
        raise ValueError(f"{cls.__name__} has no NAME")
    _FILTERS[cls.NAME] = cls
    return cls


def _ensure_backends_loaded() -> None:
    from . import backends as _  # noqa: F401 - registers built-ins


def find_filter(name: str) -> Type[FilterFramework]:
    """Reference: nnstreamer_filter_find (tensor_filter_common.c:722)."""
    _ensure_backends_loaded()
    if name in ("auto", None, ""):
        raise ValueError("use detect_framework for framework=auto")
    if name not in _FILTERS:
        raise KeyError(f"unknown filter framework {name!r}; "
                       f"known: {sorted(_FILTERS)}")
    return _FILTERS[name]


def list_filters() -> List[str]:
    _ensure_backends_loaded()
    return sorted(_FILTERS)


def detect_framework(model: Any,
                     priority: Optional[Sequence[str]] = None) -> str:
    """``framework=auto`` resolution by model kind + priority order.

    Reference: gst_tensor_filter_detect_framework
    (tensor_filter_common.c:1208-1345).
    """
    _ensure_backends_loaded()
    names = list(priority or _AUTO_PRIORITY) + [
        n for n in sorted(_FILTERS) if n not in (priority or _AUTO_PRIORITY)]
    for name in names:
        cls = _FILTERS.get(name)
        if cls is not None and cls.handles_model(model):
            return name
    raise FilterError(f"no framework recognizes model {model!r}")


# ---------------------------------------------------------------------------
# shared-model table (reference: tensor_filter_common.c:2910-3045)
# ---------------------------------------------------------------------------

class _SharedModelTable:
    """Backends shared across filter instances by ``shared_tensor_filter_key``
    — this shares the device-resident model between pipeline branches, the
    analogue of the reference sharing a tflite interpreter."""

    def __init__(self) -> None:
        self._table: Dict[str, Tuple[FilterFramework, int]] = {}
        self._lock = threading.Lock()

    def acquire(self, key: str, factory) -> FilterFramework:
        with self._lock:
            if key in self._table:
                fw, refs = self._table[key]
                self._table[key] = (fw, refs + 1)
                return fw
            fw = factory()
            self._table[key] = (fw, 1)
            return fw

    def release(self, key: str) -> bool:
        """Returns True when the last ref dropped (caller should close)."""
        with self._lock:
            if key not in self._table:
                return True
            fw, refs = self._table[key]
            if refs <= 1:
                del self._table[key]
                return True
            self._table[key] = (fw, refs - 1)
            return False

    def clear(self) -> None:
        with self._lock:
            self._table.clear()


shared_models = _SharedModelTable()


def open_backend(props: FilterProperties) -> FilterFramework:
    """Resolve (incl. ``auto``), availability-check, and open a backend,
    honoring ``shared_key`` refcounting.  Single entry point shared by the
    pipeline element and the Single API (the role of
    gst_tensor_filter_common_open_fw, tensor_filter_common.c:2420)."""
    name = props.framework
    if name in (None, "", "auto"):
        name = detect_framework(props.model)
        props.framework = name
    cls = find_filter(name)
    if not cls.check_availability(props.accelerators):
        raise FilterError(
            f"{name}: cannot serve accelerators {props.accelerators}")
    if props.shared_key:
        def factory() -> FilterFramework:
            fw = cls()
            fw.open(props)
            return fw
        return shared_models.acquire(props.shared_key, factory)
    fw = cls()
    fw.open(props)
    return fw


def close_backend(fw: Optional[FilterFramework],
                  props: FilterProperties) -> None:
    """Release/close honoring ``shared_key`` refcounting."""
    if fw is None:
        return
    if props.shared_key:
        if shared_models.release(props.shared_key):
            fw.close()
    else:
        fw.close()


class OutputTransfers:
    """Device→host copies of a dispatch's outputs, started without
    blocking: the port of the JAX package's ``start_output_transfers``.

    Each CUDA output is copied into pinned host memory owned by this
    object (``non_blocking``), and one CUDA event is recorded after the
    copies; :meth:`wait` synchronizes on the event and hands back numpy
    arrays over that memory.  Host (CPU tensor or numpy) outputs pass
    through.  Downstream reads the bytes after later dispatches have been
    queued, so the copies overlap them."""

    def __init__(self, outs) -> None:
        import torch

        self._host: List[Any] = []
        self._event = None
        for o in outs:
            if isinstance(o, torch.Tensor) and o.is_cuda:
                host = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                host.copy_(o, non_blocking=True)
                o = host
                if self._event is None:
                    self._event = torch.cuda.Event()
            self._host.append(o)
        if self._event is not None:
            self._event.record()

    def wait(self) -> List[Any]:
        from ..tensor.buffer import to_host

        if self._event is not None:
            self._event.synchronize()
        return [to_host(o) for o in self._host]


def start_output_transfers(outs) -> OutputTransfers:
    """Begin device→host copies of invoke outputs without blocking; the
    returned object's ``wait()`` gives the host arrays."""
    return OutputTransfers(outs)


# ---------------------------------------------------------------------------
# statistics (reference: GstTensorFilterStatistics tensor_filter_common.h:80-91)
# ---------------------------------------------------------------------------

STAT_MAX_RECENT = 10  # reference GST_TF_STAT_MAX_RECENT


class FilterStatistics:
    """Per-instance invoke latency/throughput, averaged over the last 10
    invokes (reference tensor_filter.c:781-791 record path)."""

    def __init__(self) -> None:
        self.total_invokes = 0
        self.total_latency_ns = 0
        self._recent: List[int] = []
        self._first_invoke_ns: Optional[int] = None
        self._last_invoke_ns: Optional[int] = None
        self._lock = threading.Lock()

    def record(self, latency_ns: int) -> None:
        now = time.monotonic_ns()
        with self._lock:
            self.total_invokes += 1
            self.total_latency_ns += latency_ns
            self._recent.append(latency_ns)
            if len(self._recent) > STAT_MAX_RECENT:
                self._recent.pop(0)
            if self._first_invoke_ns is None:
                self._first_invoke_ns = now
            self._last_invoke_ns = now

    @property
    def latency_us(self) -> int:
        """Average invoke latency over the last 10 invokes, µs (the
        reference's readable ``latency`` property)."""
        with self._lock:
            if not self._recent:
                return -1
            return int(sum(self._recent) / len(self._recent) / 1000)

    @property
    def throughput(self) -> float:
        """Outputs per second over the instance lifetime."""
        with self._lock:
            if (self.total_invokes < 2 or self._first_invoke_ns is None
                    or self._last_invoke_ns == self._first_invoke_ns):
                return 0.0
            span = (self._last_invoke_ns - self._first_invoke_ns) / 1e9
            return (self.total_invokes - 1) / span
