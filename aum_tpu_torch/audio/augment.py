"""Train-time augmentations and the dataset normalization of log-mels.

Counterpart of ``aum_tpu/audio/augment.py``: batched SpecAugment masking,
waveform mixup and the SpeechCommands noise + time roll, run on the batch's
device, and ``normalize``. Each augmentation is split in two: a *draw* of its
random values from an explicit ``torch.Generator`` (on the batch's device),
and an *apply* that is a plain function of those values, so that a test can
hand the JAX function's draws to the port. The semantics are the JAX
package's, which follow the reference's data loader:

- SpecAugment: one frequency mask, then one time mask, each skipped when its
  parameter is 0; a mask's width is drawn from 0..param, its start as
  ``floor(U * (len - width + 1))``, and the masked values become 0;
- mixup: lam ~ Beta(beta, beta), a partner drawn uniformly from
  ``concat(batch, partner_pool)``, mixed when ``U < rate``; the mixed
  waveform is re-mean-centred and the labels mixed with the same lam;
- noise: ``fb + U[0,1) * (U / 10)`` per sample, then a roll along time by a
  shift drawn from -roll_max..roll_max - 1.

lam is drawn as G1 / (G1 + G2) from two standard Gamma(beta) draws, since
``torch.distributions.Beta`` takes no generator.
"""

from __future__ import annotations

import torch


def normalize(fb: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """Dataset normalization: (x - mean) / (2 * std), as the reference's
    data loader does."""
    return (fb - mean) / (2.0 * std)


def draw_mask(generator: torch.Generator, batch: int, axis_len: int, param: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(width, start), each (batch,) int64: one mask per sample along an axis
    of ``axis_len``."""
    device = generator.device
    width = torch.randint(0, param + 1, (batch,), generator=generator, device=device)
    u = torch.rand((batch,), generator=generator, device=device)
    start = torch.floor(u * (axis_len - width + 1).float()).long()
    return width, start


def apply_mask(x: torch.Tensor, width: torch.Tensor, start: torch.Tensor, axis: int,
               mask_value: float = 0.0) -> torch.Tensor:
    """x (B, T, F) with positions start <= p < start + width of ``axis`` (1 or
    2) set to ``mask_value``, per sample."""
    pos = torch.arange(x.shape[axis], device=x.device)
    m = (pos[None] >= start[:, None]) & (pos[None] < (start + width)[:, None])
    shape = [x.shape[0], 1, 1]
    shape[axis] = x.shape[axis]
    return x.masked_fill(m.reshape(shape), mask_value)


def draw_spec_augment(generator: torch.Generator, shape: tuple, freqm: int, timem: int
                      ) -> list[tuple[int, torch.Tensor, torch.Tensor]]:
    """The masks of one SpecAugment call on (B, T, F): a list of (axis,
    width, start), the frequency mask (axis 2) first; a parameter of 0 draws
    no mask."""
    b, t, f = shape
    masks = []
    for axis, length, param in ((2, f, freqm), (1, t, timem)):
        if param > 0:
            masks.append((axis, *draw_mask(generator, b, length, param)))
    return masks


def apply_spec_augment(fb: torch.Tensor, masks) -> torch.Tensor:
    for axis, width, start in masks:
        fb = apply_mask(fb, width, start, axis)
    return fb


def spec_augment(generator: torch.Generator, fb: torch.Tensor, freqm: int, timem: int
                 ) -> torch.Tensor:
    """Batched SpecAugment masking of fb (B, T, F)."""
    return apply_spec_augment(fb, draw_spec_augment(generator, fb.shape, freqm, timem))


def draw_mixup(generator: torch.Generator, batch: int, pool: int, beta: float = 10.0
               ) -> dict:
    """{'lam': (B,) fp32 in (0, 1), 'partner': (B,) int64 in 0..pool - 1,
    'u': (B,) fp32 uniforms, mixed where u < rate}."""
    device = generator.device
    conc = torch.full((batch,), float(beta), device=device)
    g1 = torch._standard_gamma(conc, generator=generator)
    g2 = torch._standard_gamma(conc, generator=generator)
    partner = torch.randint(0, pool, (batch,), generator=generator, device=device)
    u = torch.rand((batch,), generator=generator, device=device)
    return {"lam": g1 / (g1 + g2), "partner": partner, "u": u}


def apply_mixup(wave: torch.Tensor, labels: torch.Tensor, draws: dict, mixup_rate: float,
                partner_wave: torch.Tensor | None = None,
                partner_labels: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    if partner_wave is not None:
        pool_w = torch.cat([wave, partner_wave])
        pool_y = torch.cat([labels, partner_labels])
    else:
        pool_w, pool_y = wave, labels
    lam = torch.where(draws["u"] < mixup_rate, draws["lam"], torch.ones_like(draws["lam"]))
    lam = lam[:, None]
    partner = draws["partner"]
    mixed = lam * wave + (1.0 - lam) * pool_w[partner]
    mixed = mixed - mixed.mean(dim=1, keepdim=True)
    return mixed, lam * labels + (1.0 - lam) * pool_y[partner]


def mixup_waveforms(generator: torch.Generator, wave: torch.Tensor, labels: torch.Tensor,
                    mixup_rate: float, beta: float = 10.0,
                    partner_wave: torch.Tensor | None = None,
                    partner_labels: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched waveform mixup of wave (B, S), labels (B, C), with partners
    from the batch and the optional extra pool (P, S), (P, C)."""
    pool = wave.shape[0] + (0 if partner_wave is None else partner_wave.shape[0])
    draws = draw_mixup(generator, wave.shape[0], pool, beta)
    return apply_mixup(wave, labels, draws, mixup_rate, partner_wave, partner_labels)


def draw_noise_and_roll(generator: torch.Generator, shape: tuple, roll_max: int = 10) -> dict:
    """{'noise': (B, T, F) U[0, 1), 'scale': (B, 1, 1) U[0, 1) / 10,
    'shift': (B,) int64 in -roll_max..roll_max - 1}."""
    b = shape[0]
    device = generator.device
    noise = torch.rand(shape, generator=generator, device=device)
    scale = torch.rand((b, 1, 1), generator=generator, device=device) / 10.0
    shift = torch.randint(-roll_max, roll_max, (b,), generator=generator, device=device)
    return {"noise": noise, "scale": scale, "shift": shift}


def apply_noise_and_roll(fb: torch.Tensor, draws: dict) -> torch.Tensor:
    t = fb.shape[1]
    fb = fb + draws["noise"] * draws["scale"]
    idx = (torch.arange(t, device=fb.device)[None] - draws["shift"][:, None]) % t
    return torch.gather(fb, 1, idx[:, :, None].expand(-1, -1, fb.shape[2]))


def noise_and_roll(generator: torch.Generator, fb: torch.Tensor, roll_max: int = 10
                   ) -> torch.Tensor:
    """SpeechCommands noise augmentation of fb (B, T, F)."""
    return apply_noise_and_roll(fb, draw_noise_and_roll(generator, fb.shape, roll_max))


def draw_augment(generator: torch.Generator, shape: tuple, freqm: int, timem: int,
                 noise: bool) -> dict:
    """The draws of a (B, T, F) batch's SpecAugment ('spec_augment', when
    freqm or timem), then of its noise and roll ('noise', when noise)."""
    draws = {}
    if freqm or timem:
        draws["spec_augment"] = draw_spec_augment(generator, shape, freqm, timem)
    if noise:
        draws["noise"] = draw_noise_and_roll(generator, shape)
    return draws
