"""The PyTorch port's augmentations against the JAX package's, on the CPU.

Each *apply* function of ``aum_tpu_torch.audio.augment`` is given the values
that the JAX function draws (recomputed here with the same
``jax.random`` splits the function makes) and held against the JAX output:
SpecAugment masks exactly, mixup and noise + roll within 1e-6. The port's
own *draws* are checked for their bounds: widths <= param, starts inside
the axis, roll shifts in -10..9, lam in (0, 1), partners inside the pool.

torch is imported inside the tests, as in the other port test modules.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aum_tpu.audio import augment as jaug


def _fb(seed, shape=(6, 40, 24)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# The JAX functions and draws are jitted: one compile each, where eager
# dispatch compiles every primitive (JAX's random bits are the same).
_jax_spec_augment = jax.jit(jaug.spec_augment, static_argnums=(2, 3))
_jax_mixup = jax.jit(jaug.mixup_waveforms, static_argnums=(3,))
_jax_noise_and_roll = jax.jit(jaug.noise_and_roll)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_mask_draws(key, b, axis_len, param):
    """(width, start) as ``aum_tpu.audio.augment.spec_augment`` draws them
    from its two keys."""
    kw, ks = key
    width = jax.random.randint(kw, (b,), 0, param + 1)
    start = jnp.floor(jax.random.uniform(ks, (b,)) * (axis_len - width + 1).astype(jnp.float32))
    return width, start.astype(jnp.int32)


def jax_spec_augment_draws(key, shape, freqm, timem):
    """The port's mask list for ``jaug.spec_augment(key, fb, freqm, timem)``."""
    import torch

    b, t, f = shape
    keys = jax.random.split(key, 4)
    masks = []
    for axis, length, param, ks in ((2, f, freqm, keys[0:2]), (1, t, timem, keys[2:4])):
        if param > 0:
            w, s = _jax_mask_draws(ks, b, length, param)
            masks.append((axis, torch.tensor(np.asarray(w)).long(),
                          torch.tensor(np.asarray(s)).long()))
    return masks


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_mixup_draws(key, b, pool, beta=10.0):
    k1, k2, k3 = jax.random.split(key, 3)
    return (jax.random.beta(k1, beta, beta, (b,)), jax.random.randint(k2, (b,), 0, pool),
            jax.random.uniform(k3, (b,)))


def jax_mixup_draws(key, b, pool):
    """The port's mixup draws for ``jaug.mixup_waveforms(key, ...)`` with a
    partner pool of ``pool`` clips."""
    import torch

    lam, partner, u = (np.asarray(a) for a in _jax_mixup_draws(key, b, pool))
    return {"lam": torch.tensor(lam), "partner": torch.tensor(partner).long(),
            "u": torch.tensor(u)}


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_noise_draws(key, shape, roll_max=10):
    b = shape[0]
    k1, k2, k3 = jax.random.split(key, 3)
    return (jax.random.uniform(k1, shape, jnp.float32),
            jax.random.uniform(k2, (b, 1, 1), jnp.float32) / 10.0,
            jax.random.randint(k3, (b,), -roll_max, roll_max))


def jax_noise_draws(key, shape):
    """The port's draws for ``jaug.noise_and_roll(key, fb)``, fb of ``shape``."""
    import torch

    noise, scale, shift = (np.asarray(a) for a in _jax_noise_draws(key, tuple(shape)))
    return {"noise": torch.tensor(noise), "scale": torch.tensor(scale),
            "shift": torch.tensor(shift).long()}


@pytest.mark.parametrize("freqm,timem", [(8, 16), (0, 39), (24, 0)])
def test_spec_augment_apply_matches_jax(freqm, timem):
    import torch

    from aum_tpu_torch.audio.augment import apply_spec_augment

    fb = _fb(1)
    key = jax.random.PRNGKey(7)
    want = np.asarray(_jax_spec_augment(key, jnp.asarray(fb), freqm, timem))
    masks = jax_spec_augment_draws(key, fb.shape, freqm, timem)
    got = apply_spec_augment(torch.from_numpy(fb), masks).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want == 0).any()  # some mask is not empty


@pytest.mark.parametrize("with_pool", [False, True], ids=["batch", "batch_and_pool"])
def test_mixup_apply_matches_jax(with_pool):
    import torch

    from aum_tpu_torch.audio.augment import apply_mixup

    rng = np.random.default_rng(2)
    wave = (0.1 * rng.standard_normal((8, 500)) + 0.02).astype(np.float32)
    labels = np.eye(5, dtype=np.float32)[np.arange(8) % 5]
    pw = (0.1 * rng.standard_normal((8, 500))).astype(np.float32) if with_pool else None
    pl = np.eye(5, dtype=np.float32)[(np.arange(8) + 2) % 5] if with_pool else None
    key = jax.random.PRNGKey(3)
    jpw = None if pw is None else jnp.asarray(pw)
    jpl = None if pl is None else jnp.asarray(pl)
    want_w, want_y = _jax_mixup(key, jnp.asarray(wave), jnp.asarray(labels), 0.6,
                                partner_wave=jpw, partner_labels=jpl)
    draws = jax_mixup_draws(key, 8, 16 if with_pool else 8)
    t = (lambda a: None if a is None else torch.from_numpy(a))  # noqa: E731
    got_w, got_y = apply_mixup(t(wave), t(labels), draws, 0.6, t(pw), t(pl))
    # fp32 on both sides, the same operations; the re-centring mean sums 500
    # values in other orders.
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0, atol=1e-6)
    mixed = (draws["u"] < 0.6).numpy()
    assert mixed.any() and not mixed.all()


def test_noise_and_roll_apply_matches_jax():
    import torch

    from aum_tpu_torch.audio.augment import apply_noise_and_roll

    fb = _fb(4)
    key = jax.random.PRNGKey(11)
    want = np.asarray(_jax_noise_and_roll(key, jnp.asarray(fb)))
    draws = jax_noise_draws(key, fb.shape)
    got = apply_noise_and_roll(torch.from_numpy(fb), draws).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (draws["shift"] != 0).any()


def test_port_draws_are_in_bounds():
    import torch

    from aum_tpu_torch.audio.augment import (
        apply_spec_augment,
        draw_mixup,
        draw_noise_and_roll,
        draw_spec_augment,
    )

    g = torch.Generator().manual_seed(5)
    b, t, f = 4096, 30, 12
    masks = draw_spec_augment(g, (b, t, f), 7, 30)
    assert [m[0] for m in masks] == [2, 1]
    for axis, width, start in masks:
        length, param = (f, 7) if axis == 2 else (t, 30)
        assert int(width.min()) == 0 and int(width.max()) == param
        assert int(start.min()) >= 0 and bool(((start + width) <= length).all())
    # Each sample's masked cells are its two rectangles.
    x = apply_spec_augment(torch.ones((b, t, f)), masks)
    (_, wf, _), (_, wt, _) = masks
    masked = (x == 0).sum(dim=(1, 2))
    assert torch.equal(masked, wf * t + wt * f - wf * wt)
    assert draw_spec_augment(g, (b, t, f), 0, 0) == []

    mix = draw_mixup(g, b, 16)
    assert 0 < float(mix["lam"].min()) and float(mix["lam"].max()) < 1
    assert abs(float(mix["lam"].mean()) - 0.5) < 0.01  # Beta(10, 10), sd 0.109
    assert int(mix["partner"].min()) == 0 and int(mix["partner"].max()) == 15
    assert 0 <= float(mix["u"].min()) and float(mix["u"].max()) < 1

    noise = draw_noise_and_roll(g, (b, t, f))
    assert int(noise["shift"].min()) == -10 and int(noise["shift"].max()) == 9
    assert 0 <= float(noise["noise"].min()) and float(noise["noise"].max()) < 1
    assert 0 <= float(noise["scale"].min()) and float(noise["scale"].max()) < 0.1
