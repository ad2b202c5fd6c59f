"""Executable stage chain of a :class:`LayeredModel` at a legal cut list
(twin of ``repro/runtime/partition.py``).

A :class:`Partition` is K+1 callables that run the stages, with each
inter-stage activation crossing between them through the wire codec
(``runtime.wire``).  Legality goes through ``core.split.validate_cuts``.
``head`` is stage 0 and ``tail`` everything after the first cut, so
``tail(head(x)) == apply(x)`` for any number of cuts.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.core import bottleneck as B
from repro_torch.core.split import validate_cuts
from repro_torch.device import resolve_device
from repro_torch.models.layered import LayeredModel
from repro_torch.runtime import wire as W


def _is_single_ae(ae: dict) -> bool:
    """One bottleneck AE ({'enc': .., 'dec': ..}) vs a cut -> AE map."""
    return "enc" in ae and "dec" in ae


@dataclass
class Partition:
    """Stage callables for an ordered cut list.

    ``split_layer`` is one cut or a cut sequence; the normalised tuple is
    :attr:`splits` and ``split_layer`` becomes the first cut.  ``ae`` is
    one AE dict (attached to the first cut) or a ``{cut: ae}`` map;
    :attr:`ae_map` is the normalised form.  ``params`` and the AEs must
    live on ``device``.
    """
    model: LayeredModel
    params: list
    split_layer: object              # int | ordered cut sequence
    ae: Optional[dict] = None
    device: object = "cuda"
    _fused: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.splits = validate_cuts(self.model, self.split_layer)
        self.split_layer = self.splits[0]
        if self.ae is None:
            self.ae_map = {}
        elif _is_single_ae(self.ae):
            self.ae_map = {self.splits[0]: self.ae}
        else:
            self.ae_map = dict(self.ae)
            self.ae = self.ae_map.get(self.splits[0])
        tensors = [t for p in self.params for t in p.values()]
        tensors += [t for ae in self.ae_map.values()
                    for part in ae.values() for t in part.values()]
        for t in tensors:
            if t.device != self.device:
                raise ValueError(f"a parameter lives on {t.device}, the "
                                 f"partition on {self.device}")
        self._bounds = ((0,) + tuple(c + 1 for c in self.splits)
                        + (len(self.model.layers),))

    def _range(self, x: torch.Tensor, start: int, stop: int) -> torch.Tensor:
        with torch.inference_mode():
            return self.model.apply_range(self.params, x, start, stop)

    # ------------------------------------------------------------ stages ----
    @property
    def n_stages(self) -> int:
        return len(self.splits) + 1

    def stage(self, k: int):
        """The stage-k callable (layers between cuts k-1 and k)."""
        a, b = self._bounds[k], self._bounds[k + 1]
        return lambda x: self._range(x, a, b)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Device side: layers [0, splits[0]] -> first boundary activation."""
        return self._range(x, 0, self._bounds[1])

    def tail(self, f: torch.Tensor) -> torch.Tensor:
        """Everything after the first cut: boundary activation -> logits."""
        return self._range(f, self._bounds[1], self._bounds[-1])

    def full(self, x: torch.Tensor) -> torch.Tensor:
        """Unsplit reference forward (equivalence oracle)."""
        return self.tail(self.head(x))

    def forward_stages(self, x: torch.Tensor) -> torch.Tensor:
        """Run the whole stage chain in turn (no codec): equal to :meth:`full`
        by construction, the multi-stage equivalence oracle."""
        for k in range(self.n_stages):
            x = self.stage(k)(x)
        return x

    # ----------------------------------------------------- fused boundary ----
    def wire_kinds(self, quantize: bool = True) -> tuple:
        """Per-hop payload kind ('f32' | 'int8' | 'ae8')."""
        return tuple(W.wire_kind(self.ae_map.get(c), quantize)
                     for c in self.splits)

    def fused_segments(self, *, quantize: bool = True) -> list:
        """K+1 wire-to-wire callables, the fused-boundary runtime.

        * segment 0: ``x -> (data, scales)``: the stage-0 layers with the
          hop-0 encode as epilogue (the ``bottleneck_compress`` kernel for
          'ae8'), so the boundary activation stays on the device;
        * middle segment k: ``(data, scales) -> (data, scales)``: the hop
          k-1 decode as prologue (the ``bottleneck_decompress`` kernel for
          'ae8'), the stage layers, the hop-k encode;
        * last segment: ``(data, scales) -> logits``.

        Each is a plain Python callable: PyTorch runs eagerly, so a segment
        launches its layers and kernels on the current stream one after
        another.  Byte framing stays outside (``wire.frame_arrays``).
        """
        if quantize not in self._fused:
            self._fused[quantize] = self._build_fused(quantize)
        return self._fused[quantize]

    def _build_fused(self, quantize: bool) -> list:
        bounds = self._bounds
        aes = [self.ae_map.get(c) for c in self.splits]
        kinds = self.wire_kinds(quantize)
        n = len(self.splits)

        def enc(f, k):
            with torch.inference_mode():
                return W.encode_arrays(f, aes[k], quantize=quantize)

        def dec(boundary, k):
            with torch.inference_mode():
                return W.decode_arrays(kinds[k], boundary[0], boundary[1], aes[k])

        segs = [lambda x: enc(self._range(x, 0, bounds[1]), 0)]
        for k in range(1, n + 1):
            a, b = bounds[k], bounds[k + 1]
            if k < n:
                segs.append(lambda bd, a=a, b=b, k=k:
                            enc(self._range(dec(bd, k - 1), a, b), k))
            else:
                segs.append(lambda bd, a=a, b=b, k=k:
                            self._range(dec(bd, k - 1), a, b))
        return segs

    def fused_forward(self, x: torch.Tensor, *, quantize: bool = True) -> torch.Tensor:
        """Run the whole fused segment chain (no byte framing)."""
        segs = self.fused_segments(quantize=quantize)
        cur = segs[0](x)
        for seg in segs[1:]:
            cur = seg(cur)
        return cur

    # ------------------------------------------------------------ shapes ----
    def boundary_shape(self, batch: int = 1, hop: int = 0) -> tuple:
        """Activation shape crossing wire hop ``hop`` (with batch dim)."""
        return tuple(self.model.activation_shapes(
            self.params, batch)[self.splits[hop]])

    def describe(self) -> str:
        """The cut layers in one line, as the reference writes it: head and
        tail for one cut, each stage's layers for several, then the AEs."""
        m = self.model
        if len(self.splits) == 1:
            return (f"{m.name}: head=[0..{self.split_layer}] "
                    f"tail=[{self.split_layer + 1}..{len(m.layers) - 1}]"
                    f"{' +ae' if self.ae is not None else ''}")
        bounds = self._bounds
        stages = " | ".join(f"stage{i}=[{a}..{b - 1}]"
                            for i, (a, b) in enumerate(zip(bounds, bounds[1:])))
        aes = sorted(self.ae_map)
        return f"{m.name}: {stages}{' +ae@' + str(aes) if aes else ''}"


def make_partition(model: LayeredModel, params, split_layer,
                   ae: Optional[dict] = None, *, device="cuda") -> Partition:
    """Build (and legality-check) a runnable partition at one cut (int)
    or an ordered cut list (sequence)."""
    return Partition(model, params, split_layer, ae, device)


def head_with_encoder(part: Partition, x: torch.Tensor) -> torch.Tensor:
    """The paper's edge stage: head layers + AE encoder, the f32 latent (no
    quantisation), through ``core.bottleneck.head_forward``; kept for parity
    checks between the runtime path and the simulator's SC forward."""
    return B.head_forward(part.model, part.params, part.ae, part.split_layer, x)
