"""ProxyFamily registry and the packed parameter format.

A **family** owns everything the system needs to know about one class of
proxy scorer: how to **train** it (``train(x, y, seed, device)``), how to
**score** with raw params (the reference path the optimizer uses on its
small sample), and how to **pack** params into the folded depth-1 MLP form
(``training.proxy_models.PackedProxy``) that the fused cascade kernel runs:
``score(x) = relu(x @ w1 + b1) @ w2 + b2``.

Linear models embed exactly (``relu(z) - relu(-z) == z``), so one packed
format — and one fused kernel — covers every registered family.

``pack_cascade`` stacks the per-stage packed proxies of a plan into
bucket-padded ``(F, H, P)`` numpy arrays; ``unpack_cascade`` is its exact
inverse per stage.  Packing runs on the host in numpy, exactly as in the
JAX package, so equal params give byte-equal packed arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from repro_torch.training import proxy_models as pm
from repro_torch.training.proxy_models import PackedProxy


@dataclass(frozen=True)
class ProxyFamily:
    """One registered proxy-model family (linear SVM, depth-1 MLP, ...)."""

    name: str
    params_cls: Type
    train: Callable[..., object]  # (x, y in {-1,1}, seed, device) -> params
    score: Callable[[object, np.ndarray], np.ndarray]  # reference scorer
    pack: Callable[[object], PackedProxy]  # fold standardizer + lower to packed

    def __repr__(self) -> str:  # keep plan dumps readable
        return f"ProxyFamily({self.name!r})"


_REGISTRY: Dict[str, ProxyFamily] = {}
_BY_PARAMS: Dict[Type, ProxyFamily] = {}
_ALIASES = {"svm": "linear", "mlp": "mlp1"}


def register_family(family: ProxyFamily, *, aliases: Sequence[str] = ()) -> ProxyFamily:
    _REGISTRY[family.name] = family
    _BY_PARAMS[family.params_cls] = family
    for a in aliases:
        _ALIASES[a] = family.name
    return family


def get_family(name: str) -> ProxyFamily:
    """Resolve a family by canonical name or legacy alias ("svm", "mlp")."""
    key = _ALIASES.get(name, name)
    if key not in _REGISTRY:
        raise KeyError(f"unknown proxy family {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def family_of(params) -> ProxyFamily:
    """Family lookup by parameter type."""
    fam = _BY_PARAMS.get(type(params))
    if fam is None:
        raise KeyError(f"no proxy family registered for params type {type(params).__name__}")
    return fam


def family_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _host_scores(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# ------------------------------------------------------- built-in families
LINEAR = register_family(
    ProxyFamily(
        name="linear",
        params_cls=pm.LinearParams,
        train=lambda x, y, seed, device: pm.train_linear_svm(x, y, device=device),
        score=lambda p, x: _host_scores(pm.linear_score(p, x)),
        pack=pm.pack_linear,
    ),
    aliases=("svm",),
)

MLP1 = register_family(
    ProxyFamily(
        name="mlp1",
        params_cls=pm.MLPParams,
        train=lambda x, y, seed, device: pm.train_mlp(x, y, seed=seed, device=device),
        score=lambda p, x: _host_scores(pm.mlp_score(p, x)),
        pack=pm.pack_mlp,
    ),
    aliases=("mlp",),
)


def _packed_train_unsupported(x, y, seed, device):
    raise TypeError(
        "the 'packed1' family is a wire/device format, not a trainable one: "
        "its folded params no longer carry the training-side "
        "parameterization (standardizer, raw weights)")


# The already-folded depth-1 form itself, registered as a family so plans
# carried across from the JAX package as PackedProxy params run everywhere
# downstream unchanged (pack == identity).
PACKED1 = register_family(
    ProxyFamily(
        name="packed1",
        params_cls=pm.PackedProxy,
        train=_packed_train_unsupported,
        score=lambda p, x: pm.packed_score(p, np.asarray(x, np.float32)),
        pack=lambda p: p,
    ),
)


# ------------------------------------------------- cascade-level packing
# Hidden widths are padded to a small bucket ladder so every cascade falls
# into one of a few (F, H, P) shape classes.
HIDDEN_BUCKETS = (2, 4, 8, 16, 32, 64, 128)


def hidden_bucket(h: int) -> int:
    for b in HIDDEN_BUCKETS:
        if h <= b:
            return b
    # beyond the ladder: round up to the next multiple of the top bucket
    top = HIDDEN_BUCKETS[-1]
    return ((h + top - 1) // top) * top


class PackedCascade(NamedTuple):
    """Whole-cascade packed parameters, bucket-padded to static shapes.

    ``w1[(f, h, p)]`` is hidden weight ``h`` of stage ``p``; hidden slots
    ``h >= hidden[p]`` are zero (inert).  ``dtype`` names the weight
    storage: ``"float32"``; ``"int8"`` (integer codes, per-column hidden
    scales folded into ``b1`` and the readout, ``out_scale`` the single
    dequantizing multiply); or ``"fp8"`` (values rounded to the e4m3 grid
    and stored as float32, as the JAX package stores them).
    """

    w1: np.ndarray  # (F, H, P) float32 | int8 codes
    b1: np.ndarray  # (H, P) float32 (scale-folded when quantized)
    w2: np.ndarray  # (H, P) float32 | int8 readout codes
    b2: np.ndarray  # (P,) float32
    hidden: Tuple[int, ...]  # true per-stage hidden widths
    families: Tuple[str, ...]  # per-stage family names
    dtype: str = "float32"  # weight storage format
    out_scale: Optional[np.ndarray] = None  # (P,) f32 readout scales (quantized only)

    @property
    def n_features(self) -> int:
        return int(self.w1.shape[0])

    @property
    def H(self) -> int:
        return int(self.w1.shape[1])

    @property
    def n_stages(self) -> int:
        return int(self.w1.shape[2])


def pack_cascade(param_list: Sequence[object], *,
                 pack_fn: Callable[[object], PackedProxy] = None) -> PackedCascade:
    """Pack every stage's params (any mix of families) into one
    bucket-padded (F, H, P) array set.  ``pack_fn`` overrides the per-proxy
    packer (``kernels.ops.pack_proxy_cached`` memoizes the fold)."""
    if not param_list:
        raise ValueError("pack_cascade needs at least one proxy")
    packs: List[PackedProxy] = []
    fams: List[str] = []
    for p in param_list:
        fam = family_of(p)
        packs.append(pack_fn(p) if pack_fn is not None else fam.pack(p))
        fams.append(fam.name)
    F = packs[0].w1.shape[0]
    for pk in packs:
        if pk.w1.shape[0] != F:
            raise ValueError("all cascade stages must share the feature dim")
    H = hidden_bucket(max(pk.hidden for pk in packs))
    P = len(packs)
    w1 = np.zeros((F, H, P), np.float32)
    b1 = np.zeros((H, P), np.float32)
    w2 = np.zeros((H, P), np.float32)
    b2 = np.zeros(P, np.float32)
    for p, pk in enumerate(packs):
        h = pk.hidden
        w1[:, :h, p] = pk.w1
        b1[:h, p] = pk.b1
        w2[:h, p] = pk.w2
        b2[p] = pk.b2
    return PackedCascade(w1=w1, b1=b1, w2=w2, b2=b2,
                         hidden=tuple(pk.hidden for pk in packs),
                         families=tuple(fams))


def unpack_cascade(packed: PackedCascade, col: int) -> PackedProxy:
    """Inverse of ``pack_cascade`` for one stage (bit-exact for fp32).  For
    a quantized cascade it returns the fp32 depth-1 MLP computing the same
    quantized function: codes as hidden weights, scale-folded bias, and
    ``out_scale`` multiplied back into the readout."""
    h = packed.hidden[col]
    w1 = np.ascontiguousarray(packed.w1[:, :h, col], np.float32)
    w2 = np.ascontiguousarray(packed.w2[:h, col], np.float32)
    if packed.out_scale is not None:
        w2 = w2 * np.float32(packed.out_scale[col])
    return PackedProxy(
        w1=w1,
        b1=np.ascontiguousarray(packed.b1[:h, col]),
        w2=w2,
        b2=np.float32(packed.b2[col]),
        hidden=h,
    )


# ---------------------------------------------------- weight-only quantization
QUANT_DTYPES = ("float32", "int8", "fp8")
# bytes per weight element as the kernel would move it at native width
QUANT_WEIGHT_BYTES = {"float32": 4, "int8": 1, "fp8": 1}


def _fp8_grid(x: np.ndarray) -> np.ndarray:
    """Round to the float8_e4m3fn grid and back to fp32 through torch's
    native dtype.  Inputs are clipped to ±448 first: e4m3fn has no
    infinity and encodes overflow as NaN."""
    clipped = np.clip(x, -448.0, 448.0).astype(np.float32)
    return (torch.from_numpy(clipped).to(torch.float8_e4m3fn)
            .to(torch.float32).numpy())


def quantize_cascade(packed: PackedCascade, dtype: str = "int8") -> PackedCascade:
    """Weight-only symmetric quantization of a packed fp32 cascade, scales
    folded so the kernel dequantizes once:

    * per hidden column ``(h, p)``: ``s1 = max|w1[:, h, p]| / q_max``, codes
      ``rint(w1 / s1)``; ``s1`` commutes through the relu, so ``b1`` becomes
      ``b1 / s1`` and ``s1`` multiplies into the readout;
    * per stage ``p`` over that folded readout: ``s2 = max|w2'| / q_max``,
      codes ``rint(w2' / s2)``; ``s2`` is ``out_scale``.

    ``q_max`` is 127 for int8 and 448 for fp8 (whose codes are rounded to
    the e4m3 grid and stored as fp32).  All-zero columns take scale 1.
    """
    if packed.dtype != "float32":
        raise ValueError(f"cascade is already quantized ({packed.dtype})")
    if dtype == "float32":
        return packed
    if dtype not in QUANT_DTYPES:
        raise ValueError(f"unknown quantization dtype {dtype!r}; "
                         f"supported: {QUANT_DTYPES}")
    w1 = np.asarray(packed.w1, np.float32)
    w2 = np.asarray(packed.w2, np.float32)
    max_q = 127.0 if dtype == "int8" else 448.0
    a1 = np.max(np.abs(w1), axis=0)  # (H, P) per-hidden-column max
    s1 = np.where(a1 > 0, a1 / max_q, 1.0).astype(np.float32)
    if dtype == "int8":
        q1 = np.clip(np.rint(w1 / s1), -127, 127).astype(np.int8)
    else:
        q1 = _fp8_grid(w1 / s1)
    b1 = (np.asarray(packed.b1, np.float32) / s1).astype(np.float32)
    w2f = (w2 * s1).astype(np.float32)  # hidden scales folded into readout
    a2 = np.max(np.abs(w2f), axis=0)  # (P,) per-stage max
    s2 = np.where(a2 > 0, a2 / max_q, 1.0).astype(np.float32)
    if dtype == "int8":
        q2 = np.clip(np.rint(w2f / s2), -127, 127).astype(np.int8)
    else:
        q2 = _fp8_grid(w2f / s2)
    return PackedCascade(
        w1=q1, b1=b1, w2=q2, b2=np.asarray(packed.b2, np.float32),
        hidden=packed.hidden, families=packed.families,
        dtype=dtype, out_scale=s2,
    )


def cascade_kernel_operands(packed: PackedCascade):
    """Flatten (F, H, P) -> the kernel's two-GEMM operand layout.

    Returns ``(w1 (F, H*P), b1 (H*P,), w2 (H*P, P), b2 (P,))`` as numpy in
    h-major column order (column ``h*P + p`` is hidden unit ``h`` of stage
    ``p``); ``w2`` is the block-diagonal readout matrix.  Weight dtypes are
    preserved: a quantized cascade hands over int8 code matrices.
    """
    F, H, P = packed.w1.shape
    w1 = np.ascontiguousarray(packed.w1.reshape(F, H * P))
    b1 = np.ascontiguousarray(packed.b1.reshape(H * P))
    w2 = np.zeros((H * P, P), packed.w2.dtype)
    w2[np.arange(H * P), np.tile(np.arange(P), H)] = packed.w2.reshape(H * P)
    return w1, b1, w2, np.asarray(packed.b2, np.float32)
