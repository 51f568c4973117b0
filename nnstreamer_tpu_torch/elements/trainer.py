"""tensor_trainer: training driven by the stream.

The PyTorch counterpart of ``nnstreamer_tpu/elements/trainer.py`` (parity
with gst/nnstreamer/elements/gsttensor_trainer.c and the trainer ABI): a
trainer framework receives every stream frame as an (inputs, labels)
sample, trains at EOS, and reports its losses; the element keeps the
reference's training/validation split.

Frameworks, by the JAX package's names:

- ``jax``: the built-in MLP trainer (the name is kept, as the filter
  keeps ``framework=xla``): Adam on batches of float samples;
- ``mesh``: the StreamFormer LM, one :func:`~..parallel.make_train_step`
  step per (tokens, labels) frame;
- ``mesh-vision``: a registry vision model (ViT) in its training form,
  one :func:`~..parallel.vision_train.make_vision_train_step` step per
  (frames, labels) frame.

Trainers run on ``cuda:0``; ``custom=device:cpu`` asks for the CPU (the
tests' way), and without a card and without that request they raise.  On
the card every framework's step — forward, backward and Adam update —
replays one CUDA graph per batch signature (:class:`~.._cuda.GraphedStep`,
the JAX package's jitted step with donated state); each batch is copied
into the graph's static buffers through pinned staging, and the loss read
that ends a step is its one sync.
Training is on one card: a mesh axis above 1 raises "multi-card training
is not yet ported".  ``model-save-path`` (an orbax checkpoint in the JAX
package) is not yet ported either: setting it raises at start, before any
frame is trained on.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple, Type

import numpy as np
import torch

from .._cuda import GraphedStep
from ..device import resolve_device
from ..parallel.train_step import adam_update
from ..pipeline.element import Element, EOSEvent
from ..pipeline.registry import register_element
from ..tensor.caps_util import tensors_template_caps

_MESH_AXES = ("dp", "sp", "tp", "ep")


class TrainerFramework:
    """Trainer ABI (reference GstTensorTrainerFramework:
    create/destroy/start/push_data + epoch/loss stats)."""

    NAME: str = ""

    def create(self, props: Dict[str, Any]) -> None:
        raise NotImplementedError

    def push_data(self, inputs: List[np.ndarray],
                  labels: List[np.ndarray]) -> None:
        raise NotImplementedError

    def finish(self) -> Dict[str, Any]:
        """Complete training; return summary stats (epochs, final loss)."""
        raise NotImplementedError


class _GraphedTrainer(TrainerFramework):
    """A trainer whose step is :attr:`graphed`, a :class:`~.._cuda.
    GraphedStep` ``(*batch) -> loss`` set up by ``_build``: it keeps the
    losses and the host seconds of each step."""

    graphed: GraphedStep

    def _init_stats(self) -> None:
        self.losses: List[float] = []
        #: host seconds of each step, batch copy to loss read (the sync)
        self.step_s: List[float] = []

    def _run_step(self, *batch) -> None:
        """One step on a host batch: the copy into the static buffers, the
        step (a replay on the card) and the loss read."""
        t0 = time.perf_counter()
        self.losses.append(float(self.graphed(*batch)))
        self.step_s.append(time.perf_counter() - t0)

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        """Every parameter and optimizer tensor, by name (the live
        tensors, which the next step updates in place)."""
        raise NotImplementedError


_TRAINERS: Dict[str, Type[TrainerFramework]] = {}


def register_trainer(cls: Type[TrainerFramework]) -> Type[TrainerFramework]:
    _TRAINERS[cls.NAME] = cls
    return cls


def find_trainer(name: str) -> Type[TrainerFramework]:
    if name not in _TRAINERS:
        raise KeyError(f"unknown trainer {name!r}; known: {sorted(_TRAINERS)}")
    return _TRAINERS[name]


def _device(props: Dict[str, Any]) -> torch.device:
    """``custom=device:<dev>``; default the card."""
    return resolve_device(props.get("device") or None)


def mlp_params_from_jax(tree: Dict[str, Any],
                        device: Any = None) -> Dict[str, torch.Tensor]:
    """The JAX package's MLP trainer tree (``w1 (in, hidden)``, ``b1``,
    ``w2 (hidden, out)``, ``b2``; numpy or jax arrays) as the port's: the
    same names and layouts, f32 on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    return {k: torch.tensor(np.asarray(tree[k], dtype=np.float32),
                            device=device)
            for k in ("w1", "b1", "w2", "b2")}


@register_trainer
class JaxTrainer(_GraphedTrainer):
    """Built-in trainer: an MLP on float samples with Adam.

    props: num-epochs, batch-size, lr, ``hidden`` (128), ``device``.
    Samples accumulate into batches; each full batch is one step on the
    trainer's device, with Adam's step count on the device as the JAX
    package's ``opt["t"]``.  The JAX package draws its initial weights
    from ``jax.random``; :meth:`load_params` starts from its tree
    instead."""

    NAME = "jax"

    def create(self, props: Dict[str, Any]) -> None:
        self.props = props
        self.batch_size = int(props.get("batch-size", 8))
        self.epochs = int(props.get("num-epochs", 1))
        self.lr = float(props.get("lr", 1e-3))
        self.device = _device(props)
        self._samples: List[Tuple[List[np.ndarray], List[np.ndarray]]] = []
        self._init_stats()
        self._state = None
        self._carry: Optional[Dict[str, Any]] = None

    def load_params(self, tree: Dict[str, Any]) -> None:
        """Start from ``tree`` (the JAX package's ``{w1, b1, w2, b2}``)."""
        self._carry = tree

    def push_data(self, inputs, labels) -> None:
        self._samples.append((inputs, labels))

    @staticmethod
    def _stack(samples):
        """(N, in_dim), (N, out_dim) float32 arrays from sample pairs —
        one stacker for the training AND validation paths."""
        xs = np.stack([np.asarray(s[0][0], np.float32).reshape(-1)
                       for s in samples])
        ys = np.stack([np.asarray(s[1][0], np.float32).reshape(-1)
                       for s in samples])
        return xs, ys

    @staticmethod
    def _loss(p, x, y):
        """THE objective — training grads and the validation metric
        must never diverge, so both call this."""
        h = torch.relu(x @ p["w1"] + p["b1"])
        logits = h @ p["w2"] + p["b2"]
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.mean(torch.sum(logp * y, dim=-1))

    def _build(self, in_dim: int, out_dim: int) -> None:
        hidden = int(self.props.get("hidden", 128))
        if self._carry is not None:
            params = mlp_params_from_jax(self._carry, self.device)
            want = {"w1": (in_dim, hidden), "b1": (hidden,),
                    "w2": (hidden, out_dim), "b2": (out_dim,)}
            got = {k: tuple(v.shape) for k, v in params.items()}
            if got != want:
                raise ValueError(f"jax trainer: carried tree {got} does not "
                                 f"fit the samples ({want})")
        else:
            gen = torch.Generator().manual_seed(0)
            params = {
                "w1": torch.randn(in_dim, hidden, generator=gen) * 0.05,
                "b1": torch.zeros(hidden),
                "w2": torch.randn(hidden, out_dim, generator=gen) * 0.05,
                "b2": torch.zeros(out_dim),
            }
            params = {k: v.to(self.device) for k, v in params.items()}
        opt = {"m": {k: torch.zeros_like(v) for k, v in params.items()},
               "v": {k: torch.zeros_like(v) for k, v in params.items()},
               "t": torch.zeros((), dtype=torch.int32, device=self.device)}
        self._state = (params, opt)
        self.graphed = GraphedStep(self._step_fn(params, opt), self.device)

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        params, opt = self._state
        return {"t": opt["t"], **{f"{tree}.{k}": x for tree, t in
                                  (("params", params), ("m", opt["m"]),
                                   ("v", opt["v"])) for k, x in t.items()}}

    def _step_fn(self, params, opt):
        """The step on one (x, y) batch, updating ``params`` and ``opt``
        in place; returns the loss."""
        def step(x, y):
            for p in params.values():
                p.requires_grad_(True)
            try:
                with torch.enable_grad():
                    loss = self._loss(params, x, y)
                    grads = torch.autograd.grad(loss,
                                                list(params.values()))
            finally:
                for p in params.values():
                    p.requires_grad_(False)
            opt["t"].add_(1)
            adam_update(list(params.values()), list(opt["m"].values()),
                        list(opt["v"].values()), list(grads), opt["t"],
                        self.lr)
            return loss.detach()

        return step

    def _batches(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """One epoch's full batches of the stacked samples, in order."""
        xs, ys = self._stack(self._samples)
        bs = min(self.batch_size, len(xs))
        return [(xs[i:i + bs], ys[i:i + bs])
                for i in range(0, len(xs) - bs + 1, bs)]

    def finish(self) -> Dict[str, Any]:
        if not self._samples:
            return {"epochs": 0, "samples": 0, "final_loss": None}
        batches = self._batches()
        if self._state is None:
            self._build(batches[0][0].shape[1], batches[0][1].shape[1])
        for _ in range(self.epochs):
            for x, y in batches:
                self._run_step(x, y)
        return {"epochs": self.epochs, "samples": len(self._samples),
                "final_loss": self.losses[-1] if self.losses else None}

    def evaluate(self, val_data) -> float:
        """Mean loss over held-out (inputs, labels) pairs (the element's
        num-validation-samples split) with the trained params —
        validation frames never touch the optimizer, and the metric is
        the same _loss the optimizer minimized."""
        if self._state is None or not val_data:
            return float("nan")
        params, _ = self._state
        xs, ys = self._stack(val_data)
        with torch.no_grad():
            return float(self._loss(params,
                                    torch.from_numpy(xs).to(self.device),
                                    torch.from_numpy(ys).to(self.device)))


class _MeshStreamTrainer(_GraphedTrainer):
    """Shared skeleton of the mesh trainers: accumulate (inputs, labels)
    samples, build the step at the first finish, run the epoch loop (the
    host arrays are converted once; each step copies its batch into the
    step's static device buffers — bounded device memory for a trainer
    fed by an arbitrarily long stream).

    Subclasses provide ``_build()`` (set ``self._mesh``, ``self.graphed``,
    ``self._params``, ``self._opt``), ``_host_convert(inputs, labels)``,
    ``state_tensors()`` and optionally ``_summary_extra``.
    """

    def create(self, props: Dict[str, Any]) -> None:
        self.props = props
        self.epochs = int(props.get("num-epochs", 1))
        self.device = _device(props)
        wide = {a: props[a] for a in _MESH_AXES
                if a in props and int(props[a]) != 1}
        if wide:
            raise NotImplementedError(
                f"{self.NAME}: multi-card training is not yet ported "
                f"({wide}); every mesh axis must be 1")
        self._samples: List[Tuple[List[np.ndarray], List[np.ndarray]]] = []
        self._init_stats()
        self._built = False

    def push_data(self, inputs, labels) -> None:
        self._samples.append((inputs, labels))

    def _build(self) -> None:
        raise NotImplementedError

    def _host_convert(self, inputs, labels):
        raise NotImplementedError

    def _summary_extra(self) -> Dict[str, Any]:
        return {}

    def _batches(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """One epoch's (inputs, labels) host batches, one a sample."""
        return [self._host_convert(i, l) for i, l in self._samples]

    def finish(self) -> Dict[str, Any]:
        from ..parallel import mesh_info

        if not self._samples:
            return {"epochs": 0, "samples": 0, "final_loss": None}
        if not self._built:
            self._build()
        batches = self._batches()
        for _ in range(self.epochs):
            for ins, labs in batches:
                self._run_step(ins, labs)
        return {"epochs": self.epochs, "samples": len(self._samples),
                "final_loss": self.losses[-1] if self.losses else None,
                "mesh": mesh_info(self._mesh), **self._summary_extra()}


@register_trainer
class MeshTrainer(_MeshStreamTrainer):
    """``framework=mesh``: the stream trains the StreamFormer LM — every
    (tokens, labels) frame becomes one step of
    :func:`~..parallel.make_train_step`, with causal attention through the
    flash kernels on the card.

    props (via ``custom=``): mesh axes ``dp/sp/tp/ep`` (each 1), model
    hyperparams ``vocab/dim/heads/head_dim/mlp/layers/experts/max_seq``,
    ``lr``, ``capacity_factor``, ``aux_coef``, ``seq_parallel``, ``seed``,
    ``dtype`` (default: bf16 on the card, f32 on the CPU), ``device``.
    Samples: tensor 0 = tokens (B, T) int32, tensor 1 = labels (B, T)
    int32.
    """

    NAME = "mesh"

    def _build(self) -> None:
        from ..device import parse_dtype
        from ..parallel import make_mesh
        from ..parallel.train_step import (StreamFormerConfig,
                                           make_train_step)

        p = self.props
        axes = {a: int(p[a]) for a in _MESH_AXES if a in p}
        self._mesh = make_mesh(axis_sizes=axes or None,
                               devices=[self.device])
        cfg_kw: Dict[str, Any] = {
            k: int(p[k]) for k in ("vocab", "dim", "heads", "head_dim",
                                   "mlp", "layers", "experts", "max_seq")
            if k in p}
        for k in ("lr", "capacity_factor", "aux_coef"):
            if k in p:
                cfg_kw[k] = float(p[k])
        if "seq_parallel" in p:
            cfg_kw["seq_parallel"] = str(p["seq_parallel"])
        cfg_kw["dtype"] = parse_dtype(p.get("dtype"), self.device)
        cfg = StreamFormerConfig(**cfg_kw)
        step, self._params, self._opt, _ = make_train_step(
            self._mesh, cfg, seed=int(p.get("seed", 0)))
        self.graphed = step.graphed
        self._built = True

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        from ..parallel.train_step import leaves

        return {"step": self._opt["step"], **{
            f"{tree}.{n}": x for tree, t in
            (("params", self._params), ("m", self._opt["m"]),
             ("v", self._opt["v"])) for n, x in leaves(t)}}

    def _host_convert(self, inputs, labels):
        return (np.asarray(inputs[0], np.int32),
                np.asarray(labels[0], np.int32))


@register_trainer
class MeshVisionTrainer(_MeshStreamTrainer):
    """``framework=mesh-vision``: the stream trains a registry vision model
    in its training form (f32 parameters, compute in the model's dtype) —
    every (frames, labels) frame is one step of
    :func:`~..parallel.vision_train.make_vision_train_step`.  With
    ``model:vit`` each attention layer runs the flash kernels forward and
    backward with the batch in their grid.

    props (via ``custom=``): ``model`` (registry name, default vit),
    ``dp`` (1), ``lr``, ``device``, plus the model's custom props
    (``dim/depth/heads/patch/input_size/num_classes/seed/dtype/attn``).
    Samples: tensor 0 = frames (B, H, W, 3) uint8, tensor 1 = labels (B,)
    int32.
    """

    NAME = "mesh-vision"

    _MODEL_KEYS = ("seed", "num_classes", "input_size", "patch", "dim",
                   "depth", "heads", "dtype", "attn", "width")

    def _build(self) -> None:
        from ..models.registry import get_model
        from ..parallel import make_mesh
        from ..parallel.vision_train import make_vision_train_step

        p = self.props
        dp = int(p.get("dp", 1))
        self._mesh = make_mesh(n_devices=dp, axis_sizes={"dp": dp},
                               devices=[self.device])
        model_props = {k: str(p[k]) for k in self._MODEL_KEYS if k in p}
        self._model = get_model(str(p.get("model", "vit")), model_props,
                                device=self.device, trainable=True)
        step, self._params, self._opt, _ = make_vision_train_step(
            self._mesh, self._model, lr=float(p.get("lr", 1e-3)))
        self.graphed = step.graphed
        self._dp = dp
        self._built = True

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        out = {}
        for name, p in self._params.named_parameters():
            out[f"params.{name}"] = p.detach()
            # torch.optim.Adam's state: exp_avg, exp_avg_sq, step
            out.update({f"{k}.{name}": x
                        for k, x in self._opt.state[p].items()})
        return out

    def _host_convert(self, inputs, labels):
        from ..parallel.vision_train import pad_to_multiple

        return (pad_to_multiple(np.asarray(inputs[0], np.uint8), self._dp),
                pad_to_multiple(np.asarray(labels[0], np.int32)
                                .reshape(-1), self._dp))

    def _summary_extra(self) -> Dict[str, Any]:
        return {"model": self._model.name}


@register_element
class TensorTrainer(Element):
    FACTORY = "tensor_trainer"
    PROPERTIES = {
        "framework": ("jax", "trainer framework name"),
        "model-save-path": (None, "checkpoint path written at EOS (not "
                                  "yet ported: setting it raises)"),
        "model-config": (None, "framework model-config path (reference "
                               "property; forwarded to the trainer's "
                               "props)"),
        "num-inputs": (1, "tensors per frame that are inputs"),
        "num-labels": (1, "tensors per frame that are labels"),
        "num-epochs": (1, ""),
        "batch-size": (8, ""),
        "lr": (1e-3, ""),
        "num-training-samples": (0, "frames used for TRAINING; the "
                                    "stream's next num-validation-"
                                    "samples frames are validation "
                                    "(reference gsttensor_trainer "
                                    "split; 0 = train on everything)"),
        "num-validation-samples": (0, "frames after the training split "
                                      "held out for validation loss"),
        "custom": (None, "extra key:value props (device:cpu trains on "
                         "the CPU)"),
    }

    def _make_pads(self):
        self.add_sink_pad(tensors_template_caps(), "sink")
        self.add_src_pad(tensors_template_caps(), "src")

    def start(self):
        from ..filter.framework import FilterProperties

        if self.model_save_path not in (None, ""):
            raise NotImplementedError(
                f"{self.name}: model-save-path is not yet ported (the port "
                "has no checkpoint format; save and restore come together)")
        cls = find_trainer(str(self.framework))
        self.trainer = cls()
        props = {"num-epochs": self.num_epochs, "batch-size": self.batch_size,
                 "lr": self.lr}
        if self.model_config not in (None, ""):
            props["model-config"] = str(self.model_config)
        props.update(FilterProperties.parse_custom(self.custom))
        self._n_train = int(self.num_training_samples or 0)
        self._n_valid = int(self.num_validation_samples or 0)
        if self._n_valid > 0 and self._n_train <= 0:
            # silently training on everything would withhold the
            # promised validation loss
            raise ValueError(f"{self.name}: num-validation-samples "
                             "needs num-training-samples")
        self.trainer.create(props)
        self.summary: Optional[Dict[str, Any]] = None
        self._done = threading.Event()
        self._n_seen = 0
        self._val_data: List = []

    def set_caps(self, pad, caps):
        super().set_caps(pad, caps)  # passthrough

    def chain(self, pad, buf):
        ni = int(self.num_inputs)
        nl = int(self.num_labels)
        if buf.num_tensors < ni + nl:
            raise ValueError(
                f"{self.name}: frame has {buf.num_tensors} tensors, need "
                f"{ni}+{nl}")
        inputs = [buf.np(i) for i in range(ni)]
        labels = [buf.np(ni + i) for i in range(nl)]
        # reference split semantics (gsttensor_trainer push_data): the
        # first num-training-samples frames train, the NEXT
        # num-validation-samples are held out, anything beyond both is
        # ignored; with no split configured everything trains
        idx = self._n_seen
        self._n_seen += 1
        if self._n_train <= 0 or idx < self._n_train:
            self.trainer.push_data(inputs, labels)
        elif idx < self._n_train + self._n_valid:
            self._val_data.append((inputs, labels))
        return self.push(buf)

    def on_event(self, pad, event):
        if isinstance(event, EOSEvent):
            # train before propagating EOS (reference blocks on
            # training_complete_cond at EOS)
            self.summary = self.trainer.finish()
            if self._val_data:
                self.summary["validation_samples"] = len(self._val_data)
                evaluate = getattr(self.trainer, "evaluate", None)
                if callable(evaluate):
                    self.summary["validation_loss"] = float(
                        evaluate(self._val_data))
                self._val_data = []    # release the held-out frames
            self._done.set()
        super().on_event(pad, event)

    def wait_done(self, timeout=None) -> bool:
        return self._done.wait(timeout)
