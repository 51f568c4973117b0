"""tensor_decoder element: other/tensors → media via a decoder subplugin.

The counterpart of ``nnstreamer_tpu/elements/decoder_elem.py``, with its
parity to gst/nnstreamer/elements/gsttensor_decoder.c (mode + option1..9
properties select and configure the subplugin; custom callback mode via
``mode=custom-code`` like the reference tensor_decoder_custom.h), with
its fused-dispatch hooks (``plan_step``, and ``lower_step`` over the
decoder's ``lower_decode``).
"""

from __future__ import annotations

from ..decoders import find_decoder
from ..pipeline.caps import Caps
from ..pipeline.element import CustomEvent, Element, LoweredStep
from ..pipeline.registry import register_element
from ..tensor.caps_util import config_from_caps, tensors_template_caps


@register_element
class TensorDecoder(Element):
    FACTORY = "tensor_decoder"
    PROPERTIES = dict(
        {"mode": (None, "decoder mode name"),
         # net-new: the device-reduction pushdown (composing the pure
         # part of decode into the upstream filter's forward) can be
         # disabled to measure its delta or to force the host decode path
         "pushdown": (True, "fuse pure decode reductions into the "
                            "upstream filter's forward"),
         "sub-plugins": (None, "reference READABLE property: registered "
                               "decoder modes")},
        **{f"option{i}": (None, f"decoder option {i}") for i in range(1, 10)})

    #: reference G_PARAM_READABLE-only (enforced by Element.set_property)
    READONLY_PROPERTIES = ("sub-plugins",)

    def get_property(self, key):
        if key in ("sub-plugins", "sub_plugins"):
            from ..decoders import list_decoders

            return ",".join(list_decoders())
        return super().get_property(key)

    #: custom callbacks registered via register_decoder_custom (reference
    #: tensor_decoder_custom.h)
    _CUSTOM = {}

    @classmethod
    def register_custom(cls, name, fn):
        cls._CUSTOM[name] = fn

    def _make_pads(self):
        self.add_sink_pad(tensors_template_caps(), "sink")
        self.add_src_pad(Caps.any(), "src")

    def start(self):
        mode = str(self.mode or "")
        if not mode:
            raise ValueError(f"{self.name}: mode property required")
        if mode == "custom-code":
            fn = self._CUSTOM.get(str(self.option1))
            if fn is None:
                raise ValueError(
                    f"{self.name}: custom decoder {self.option1!r} "
                    "not registered")
            self._decoder = None
            self._custom_fn = fn
            return
        self._custom_fn = None
        self._decoder = find_decoder(mode)()
        for i in range(1, 10):
            val = getattr(self, f"option{i}")
            if val is not None:
                self._decoder.set_option(i, str(val))

    def set_caps(self, pad, caps):
        self._config = config_from_caps(caps)
        if self._decoder is not None:
            from ..utils.conf import parse_bool

            spec = (self._decoder.device_reduce_spec(self._config)
                    if parse_bool(self.pushdown) else None)
            if spec is not None:
                fn, reduced = spec
                ev = CustomEvent("nns/device-reduce",
                                 {"fn": fn, "out_info": reduced})
                if pad.push_upstream_event(ev):
                    # the filter re-announced reduced caps; that nested
                    # set_caps cascade (where device_reduce_spec returns
                    # None on the already-reduced config) completed the
                    # negotiation — nothing more to announce here
                    return
            self.announce_src_caps(self._decoder.get_out_caps(self._config))
        else:
            from ..pipeline.caps import Structure
            from fractions import Fraction

            self.announce_src_caps(Caps([Structure(
                "application/octet-stream",
                {"framerate": self._config.rate or Fraction(0, 1)})]))

    def _decode_one(self, buf):
        if self._custom_fn is not None:
            return self._custom_fn(buf, self._config)
        return self._decoder.decode(buf, self._config)

    def chain(self, pad, buf):
        return self.push(self._decode_one(buf))

    def plan_step(self):
        return self._decode_one

    def lower_reason(self):
        mode = str(self.mode or "")
        if mode == "custom-code":
            return "custom-code decoders run arbitrary host callbacks"
        try:
            dec = find_decoder(mode) if mode else None
        except KeyError:
            dec = None
        if dec is None or "lower_decode" not in vars(dec):
            return (f"decoder mode {mode!r} has no lower_decode "
                    "(pure-tensor lowering hook)")
        return None

    def lower_step(self):
        if getattr(self, "_custom_fn", None) is not None \
                or getattr(self, "_decoder", None) is None \
                or getattr(self, "_config", None) is None:
            return None
        spec = self._decoder.lower_decode(self._config)
        if spec is None:
            return None
        fn, needs_post = spec
        return LoweredStep(fn, post=self._decode_one if needs_post else None)
