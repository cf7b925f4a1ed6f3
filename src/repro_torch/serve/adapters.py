"""Multi-LoRA adapter registry of the serving engine (paper §III), PyTorch
port of the JAX package's ``serve/adapters.py``.

The base model's weights stay frozen in their quantized AxLLM form while
LoRA fine-tunes ride beside them as dense low-rank deltas, with no
parameter altered and nothing preprocessed offline. Up to ``max_loras``
adapters are stacked into per-target ``[n_layers, max_loras, ...]`` A/B
tensors on the serving device; requests carry an adapter name, and the
engine threads a per-slot ``[B]`` adapter-row array (``-1`` = base only)
through prefill waves and decode chunks, so one dispatch serves a mixed
batch (:func:`repro_torch.core.axllm_linear.lora_delta_batched` does the
gathered apply).

A registered adapter is ``{target: {"lora_a": [n_layers, n_in, rank],
"lora_b": [n_layers, rank, n_out]}}`` (tensors or numpy arrays). Targets
are the attention projections; a target an adapter lacks stays zero in
its row (B = 0 is the identity). Leaves stay dense: a :class:`QTensor`
leaf is refused, since quantizing the delta would merge the two
pipelines.

``add``/``evict`` swap adapters between waves in place: the stacked
shapes never change. On a mesh, :meth:`place` keeps this rank's block of
the stacked tensors, and later swaps cut each incoming adapter the same
way. The engine ``acquire``s an adapter at ``submit`` and
``release``s it when the request finishes, so evicting an adapter that
requests still hold raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.axllm_linear import LoRAConfig
from repro_torch.core.quantization import QTensor
from repro_torch.dist import sharding as shd

#: targets the serve path can apply (the attention projections)
SUPPORTED_TARGETS = ("wq", "wk", "wv", "wo")


def target_dims(cfg, target: str) -> Tuple[int, int]:
    """(n_in, n_out) of an attention projection weight for ``cfg``."""
    d, h, hk, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    dims = {"wq": (d, h * hd), "wk": (d, hk * hd), "wv": (d, hk * hd),
            "wo": (h * hd, d)}
    if target not in dims:
        raise ValueError(f"unsupported LoRA target {target!r}; serveable "
                         f"targets are {SUPPORTED_TARGETS}")
    return dims[target]


class AdapterRegistry:
    """Stacked multi-LoRA store read by
    :class:`~repro_torch.serve.engine.ServeEngine`.

    cfg: the ModelConfig the adapters were trained against (each target's
    shape is checked at ``add``). lora_cfg: rank/alpha/targets; every
    adapter has ``lora_cfg.rank``. max_loras: stacked capacity. The
    stacked tensors live on ``device`` (the card unless the caller passes
    ``device="cpu"``), which must be the engine's.
    """

    def __init__(self, cfg, lora_cfg: Optional[LoRAConfig] = None,
                 max_loras: int = 4, dtype=torch.float32, device="cuda"):
        if max_loras < 1:
            raise ValueError(f"max_loras must be >= 1, got {max_loras}")
        self.cfg = cfg
        self.lora_cfg = lora_cfg or LoRAConfig()
        self.max_loras = max_loras
        self.dtype = dtype
        self.device = torch.device(device)
        self.targets = tuple(self.lora_cfg.targets)
        nl, r = cfg.n_layers, self.lora_cfg.rank
        self._stacked = {}
        for t in self.targets:
            n_in, n_out = target_dims(cfg, t)        # raises on unknown
            self._stacked[t] = {
                "lora_a": torch.zeros((nl, max_loras, n_in, r), dtype=dtype,
                                      device=self.device),
                "lora_b": torch.zeros((nl, max_loras, r, n_out), dtype=dtype,
                                      device=self.device),
            }
        self._names: List[Optional[str]] = [None] * max_loras
        self._refs: List[int] = [0] * max_loras
        self._specs = None      # the mesh placement, once placed

    # -- introspection --------------------------------------------------------
    @property
    def scaling(self) -> float:
        """alpha / rank: the delta multiplier."""
        return self.lora_cfg.scaling

    @property
    def stacked(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """``{target: {"lora_a": [n_layers, max_loras, n_in, r], "lora_b":
        [n_layers, max_loras, r, n_out]}}``, updated in place by swaps."""
        return self._stacked

    @property
    def names(self) -> List[str]:
        return [n for n in self._names if n is not None]

    def __contains__(self, name: str) -> bool:
        return name in self._names

    def __len__(self) -> int:
        return len(self.names)

    def index_of(self, name: str) -> int:
        """Stacked row of ``name`` (the value requests carry per slot)."""
        try:
            return self._names.index(name)
        except ValueError:
            raise KeyError(
                f"unknown adapter {name!r}; registered: {self.names}")

    # -- validation -----------------------------------------------------------
    def _check_leaf(self, name, target, key, leaf, want_shape):
        if isinstance(leaf, QTensor):
            raise TypeError(
                f"adapter {name!r} {target}/{key} is a QTensor: LoRA deltas "
                "stay dense (bf16/fp32); only the frozen base is quantized")
        if not hasattr(leaf, "shape"):
            raise TypeError(f"adapter {name!r} {target}/{key} is not an "
                            f"array: {type(leaf)}")
        if tuple(leaf.shape) != want_shape:
            got_r = leaf.shape[-1] if key == "lora_a" else leaf.shape[-2]
            want_r = self.lora_cfg.rank
            if len(leaf.shape) == len(want_shape) and got_r != want_r:
                raise ValueError(
                    f"adapter {name!r} {target}/{key} rank {got_r} != "
                    f"registry rank {want_r} (one stacked rank per registry)")
            raise ValueError(
                f"adapter {name!r} {target}/{key} shape {tuple(leaf.shape)} "
                f"!= expected {want_shape} for model {self.cfg.name!r}")

    def _validate(self, name: str, adapter) -> None:
        if name in self._names:
            raise ValueError(f"adapter {name!r} already registered; evict "
                             "first to replace")
        if not adapter:
            raise ValueError(f"adapter {name!r} has no targets")
        unknown = set(adapter) - set(self.targets)
        if unknown:
            raise ValueError(
                f"adapter {name!r} targets {sorted(unknown)} not in registry "
                f"targets {self.targets}")
        nl, r = self.cfg.n_layers, self.lora_cfg.rank
        for t, ab in adapter.items():
            n_in, n_out = target_dims(self.cfg, t)
            if set(ab) != {"lora_a", "lora_b"}:
                raise ValueError(f"adapter {name!r} target {t!r} needs "
                                 "exactly {'lora_a', 'lora_b'} leaves")
            self._check_leaf(name, t, "lora_a", ab["lora_a"], (nl, n_in, r))
            self._check_leaf(name, t, "lora_b", ab["lora_b"], (nl, r, n_out))

    def _write(self, row: int, name: str, adapter) -> None:
        # targets absent from the adapter keep their row's zeros (free
        # rows are zero from __init__ and evict)
        for t in adapter:
            for key in ("lora_a", "lora_b"):
                new = torch.as_tensor(adapter[t][key]).to(
                    device=self.device, dtype=self.dtype)
                if self._specs is not None:
                    # [L, n_in, r] / [L, r, n_out]: the placement's spec
                    # without its max_loras entry
                    s = self._specs[t][key]
                    spec = tuple(s.spec) + (None,) * (4 - len(s.spec))
                    new = shd.local_shard(new, spec[:1] + spec[2:], s.mesh,
                                          s.mesh.rank)
                self._stacked[t][key][:, row] = new
        self._names[row] = name
        self._refs[row] = 0

    # -- mutation -------------------------------------------------------------
    def add(self, name: str, adapter) -> int:
        """Check and stack a trained adapter in the first free row; returns
        the row. Raises TypeError on a QTensor leaf, ValueError on a shape,
        rank or target mismatch or a duplicate name, and RuntimeError when
        the registry is full (evict first)."""
        self._validate(name, adapter)
        try:
            row = self._names.index(None)
        except ValueError:
            raise RuntimeError(
                f"registry full ({self.max_loras} adapters); evict one "
                "before adding")
        self._write(row, name, adapter)
        return row

    def evict(self, name: str) -> None:
        """Free ``name``'s row, zeroing it. Raises RuntimeError while any
        in-flight request still holds the adapter."""
        row = self.index_of(name)
        if self._refs[row]:
            raise RuntimeError(
                f"adapter {name!r} is assigned to {self._refs[row]} active "
                "request(s); drain them before evicting")
        for t in self.targets:
            for key in ("lora_a", "lora_b"):
                self._stacked[t][key][:, row] = 0
        self._names[row] = None
        self._refs[row] = 0

    def place(self, specs) -> None:
        """Keep this rank's block of the stacked tensors under ``specs``
        ({target: {"lora_a": NamedSharding, "lora_b": ...}}, as
        ``dist.sharding.adapter_specs`` or the engine's layout gives; each
        sharding's mesh says the rank), once, at engine init. Later
        ``add``/``evict`` cut each incoming adapter the same way, so the
        layout holds across hot swaps."""
        if self._specs is not None:
            raise RuntimeError("the registry is placed already")
        for t, mats in specs.items():
            for key, s in mats.items():
                self._stacked[t][key] = shd.local_shard(
                    self._stacked[t][key], s, s.mesh, s.mesh.rank)
        self._specs = specs

    # -- engine lifecycle -----------------------------------------------------
    def acquire(self, name: str) -> int:
        """Pin ``name`` for an in-flight request; returns its row."""
        row = self.index_of(name)
        self._refs[row] += 1
        return row

    def release(self, name: str) -> None:
        row = self.index_of(name)
        if self._refs[row] <= 0:
            raise RuntimeError(f"release of adapter {name!r} without a "
                               "matching acquire")
        self._refs[row] -= 1

    def refcount(self, name: str) -> int:
        return self._refs[self.index_of(name)]


def make_synthetic_adapters(cfg, n: int, rank: int = 8, alpha: float = 16.0,
                            targets=("wq", "wv"), max_loras=None, seed=0,
                            device="cuda"):
    """An :class:`AdapterRegistry` on ``device`` holding ``n`` random
    adapters (non-zero B), named ``adapter0`` ... Stands in for trained
    adapters in the chaos harness: small random B moves the outputs
    without wrecking the base distribution. The values are those of the
    JAX package's ``launch.serve.make_synthetic_adapters`` for the same
    arguments (one numpy generator, float32). Returns (registry, names).
    """
    lcfg = LoRAConfig(rank=rank, alpha=alpha, targets=tuple(targets))
    reg = AdapterRegistry(cfg, lcfg, max_loras=max_loras or max(4, n),
                          device=device)
    rng = np.random.default_rng(seed)
    names = []
    for i in range(n):
        ad = {}
        for t in lcfg.targets:
            n_in, n_out = target_dims(cfg, t)
            ad[t] = {
                "lora_a": (rng.normal(size=(cfg.n_layers, n_in, rank))
                           / np.sqrt(rank)).astype(np.float32),
                "lora_b": (rng.normal(size=(cfg.n_layers, rank, n_out))
                           * 0.05).astype(np.float32)}
        name = f"adapter{i}"
        reg.add(name, ad)
        names.append(name)
    return reg, names
