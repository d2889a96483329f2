"""The benchmark's own draws of a training step: every random number a
step takes from the host, made from a CPU ``torch.Generator`` seeded from
the run's seed, handed the same to the port and to the reference.

The dataclasses carry the port's class and field names, so a driver
rebuilds them as the port's classes (``train_cell.to_port``).  Refign-HRDA★
(:func:`draw_step`): the adapt-to-reference coin, DACS's coins, ClassMix
scores, jitter factors and blur sigmas, the two HRDA crop offsets and the
seed of the device generator of dropout and drop path.  UAWarpC
(:func:`draw_align`): each pair's prime coin, photometric draws and
synthetic flow, and the seed of the elastic noise fields.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def _u(gen: torch.Generator) -> float:
    return float(torch.rand((), generator=gen))


def _between(gen: torch.Generator, lo: float, hi: float) -> float:
    return lo + (hi - lo) * _u(gen)


def _order(gen: torch.Generator) -> Tuple[int, ...]:
    return tuple(int(i) for i in torch.randperm(4, generator=gen))


# ---------------------------------------------------------------------------
# Refign-HRDA★
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class JitterFactors:
    """One image's colour jitter: the four factors and the order of the
    ops (indices into brightness, contrast, saturation, hue)."""
    brightness: float
    contrast: float
    saturation: float
    hue: float
    order: Tuple[int, int, int, int]


@dataclasses.dataclass
class DACSDraws:
    """One ClassMix: the jitter and blur coins of the step, each image's
    class scores (one per class and one for the ignore label), jitter
    factors and blur sigma."""
    jitter_coin: float
    blur_coin: float
    class_scores: torch.Tensor
    jitter: List[JitterFactors]
    sigma: List[float]

    def rows(self, sl: Optional[slice]) -> "DACSDraws":
        if sl is None:
            return self
        return dataclasses.replace(self, class_scores=self.class_scores[sl],
                                   jitter=self.jitter[sl],
                                   sigma=self.sigma[sl])


@dataclasses.dataclass
class StepDraws:
    use_ref_as_target: bool
    dacs: DACSDraws
    crop_src: Tuple[int, int]
    crop_mix: Tuple[int, int]
    dropout_seed: int


def draw_dacs(gen: torch.Generator, B: int, num_classes: int, s: float,
              blur: bool) -> DACSDraws:
    jitter_coin = _u(gen)
    blur_coin = _u(gen) if blur else 0.0
    scores = torch.rand((B, num_classes + 1), generator=gen)
    jitter = []
    for _ in range(B):
        fb = _between(gen, max(0.0, 1 - s), min(2.0, 1 + s))
        fc = _between(gen, max(0.0, 1 - s), 1 + s)
        fs = _between(gen, max(0.0, 1 - s), 1 + s)
        fh = _between(gen, -s, s)
        jitter.append(JitterFactors(fb, fc, fs, fh, _order(gen)))
    sigma = [_between(gen, 0.15, 1.15) for _ in range(B)]
    return DACSDraws(jitter_coin, blur_coin, scores, jitter, sigma)


def hrda_crop(gen: torch.Generator, H: int, W: int,
              divisible: int) -> Tuple[int, int]:
    """The HR crop's origin: multiples of ``divisible`` in [0, size/2]."""
    oy = int(torch.randint(0, (H // 2 + 1) // divisible, (), generator=gen))
    ox = int(torch.randint(0, (W // 2 + 1) // divisible, (), generator=gen))
    return oy * divisible, ox * divisible


def draw_step(uda: dict, B: int, H: int, W: int,
              gen: torch.Generator) -> StepDraws:
    """The draws of one UDA step on B rows of H x W images; ``uda`` the
    configuration's ``uda`` settings."""
    coin = bool(uda["adapt_to_ref"] and _u(gen) < 0.5)
    dacs = draw_dacs(gen, B, uda["num_classes"], uda["color_jitter_s"],
                     uda["blur"])
    div = 2 * uda["hrda_output_stride"]
    crop_src = hrda_crop(gen, H, W, div)
    crop_mix = hrda_crop(gen, H, W, div)
    seed = int(torch.randint(0, 2 ** 62, (), generator=gen))
    return StepDraws(coin, dacs, crop_src, crop_mix, seed)


# ---------------------------------------------------------------------------
# UAWarpC
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PrimeDraws:
    """The prime view's photometric draws, None where off."""
    jitter: Optional[JitterFactors] = None
    perm: Optional[Tuple[int, int, int]] = None
    blur_sigma: Optional[float] = None


@dataclasses.dataclass
class FlowDraws:
    """One synthetic flow: its kind ('hom', 'tps' or 'afftps'), the
    homography's 8 or the TPS's 18 control values, the affine parameters
    (rotation, shear angle, l1, l2, tx, ty) of 'afftps'; no elastic part."""
    kind: str
    theta: Optional[Tuple[float, ...]] = None
    affine: Optional[Tuple[float, ...]] = None
    elastic: None = None


@dataclasses.dataclass
class AlignDraws:
    prime_trg_idx: Tuple[int, ...]
    photometric: List[PrimeDraws]
    flows: List[FlowDraws]
    noise_seed: int = 0
    noise_rows: Optional[Tuple[int, int]] = None

    def first(self, n: int) -> "AlignDraws":
        return AlignDraws(self.prime_trg_idx[:n], self.photometric[:n],
                          self.flows[:n], self.noise_seed)


HOM_CORNERS = (-1., -1., 1., 1., -1., 1., -1., 1.)
# the 3 x 3 TPS control grid, x then y, x slowest
TPS_GRID = tuple(float(v) for v in np.repeat([-1., 0., 1.], 3)) + \
    tuple(float(v) for v in np.tile([-1., 0., 1.], 3))


def _jittered(gen, base: Sequence[float], t: float) -> Tuple[float, ...]:
    u = torch.rand(len(base), generator=gen, dtype=torch.float32)
    return tuple((torch.tensor(base, dtype=torch.float32)
                  + (u - 0.5) * 2 * t).tolist())


def _affine(gen, a: dict) -> Tuple[float, ...]:
    f = np.float32
    rot = (f(_u(gen)) - f(0.5)) * f(2) * f(a["random_alpha"])
    sh = (f(_u(gen)) - f(0.5)) * f(2) * f(a["random_alpha"])
    l1 = f(1) + (f(2) * f(_u(gen)) - f(1)) * f(a["random_s"])
    tx = (f(2) * f(_u(gen)) - f(1)) * f(a["random_tx"])
    ty = (f(2) * f(_u(gen)) - f(1)) * f(a["random_ty"])
    return tuple(float(v) for v in (rot, sh, l1, l1, tx, ty))


def draw_flow(gen: torch.Generator, a: dict) -> FlowDraws:
    kinds = a["include_transforms"]
    kind = kinds[int(torch.randint(0, len(kinds), (), generator=gen))]
    if kind == "hom":
        return FlowDraws(kind, theta=_jittered(gen, HOM_CORNERS,
                                               a["random_t_hom"]))
    if kind == "tps":
        return FlowDraws(kind, theta=_jittered(gen, TPS_GRID,
                                               a["random_t_tps"]))
    if kind == "afftps":
        aff = _affine(gen, a)
        return FlowDraws(kind, affine=aff, theta=_jittered(
            gen, TPS_GRID, a["random_t_tps_for_afftps"]))
    raise ValueError(f"the benchmark draws no {kind!r} flows")


def draw_align(a: dict, B: int, gen: torch.Generator) -> AlignDraws:
    """The draws of one UAWarpC step of B pairs; ``a`` the configuration's
    ``align`` settings (no elastic part)."""
    if a.get("add_elastic"):
        raise ValueError("the benchmark draws no elastic flows")
    coins = tuple(int(v) for v in torch.rand(B, generator=gen) < 0.5)
    photometric = []
    for _ in range(B):
        d = PrimeDraws()
        if a.get("prime_jitter") is not None:
            b, c, s, h = a["prime_jitter"]
            d.jitter = JitterFactors(
                _between(gen, max(0.0, 1 - b), 1 + b),
                _between(gen, max(0.0, 1 - c), 1 + c),
                _between(gen, max(0.0, 1 - s), 1 + s),
                _between(gen, -h, h), _order(gen))
        if a.get("prime_channel_shuffle"):
            d.perm = tuple(int(i) for i in torch.randperm(3, generator=gen))
        if a.get("prime_blur") is not None:
            p, _, lo, hi = a["prime_blur"]
            apply = _u(gen) < p
            sigma = _between(gen, lo, hi)
            d.blur_sigma = sigma if apply else None
        photometric.append(d)
    flows = [draw_flow(gen, a) for _ in range(B)]
    seed = int(torch.randint(0, 2 ** 62, (), generator=gen))
    return AlignDraws(coins, photometric, flows, seed)
