"""The plain references held to the port on the CPU at small sizes, in fp32:
the AuM forward (Fo-Bi and Fo-Fo), the fbank frontend, the train step's
loss, gradients and Adam update, and the scan."""

from pathlib import Path

import pytest
import torch

from benchmark import aum, harness
from benchmark.drivers import train as train_driver
from benchmark.reference import fbank as ref_fbank
from benchmark.reference import precision
from benchmark.reference import train as ref_train
from benchmark.reference.scan import LinearRecurrence, selective_scan

TINY = Path(__file__).resolve().parent / "tiny"
CPU = torch.device("cpu")


def _config(name):
    return harness.load("configs", name, TINY)


@pytest.mark.parametrize("name", ["tiny-fobi", "tiny-fofo-wav"])
def test_logits_match_the_port(name):
    cfg = _config(name)
    model, shapes = aum.build_program(cfg, 11, CPU)
    f, t = cfg["model"]["spectrogram_size"]
    x = 0.5 * torch.randn((3, t, f), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = model(x)
    want = aum.reference_logits(cfg, aum.seeded_params(cfg, shapes, 11, CPU), x)
    assert aum.row_rel_err(got, want) < 1e-5


def test_fbank_matches_the_port():
    from aum_tpu_torch.serving import frontend_fn

    cfg = _config("tiny-fofo-wav")
    f, t = cfg["model"]["spectrogram_size"]
    front = cfg["frontend"]
    wav = 0.1 * torch.randn((2, 10560), generator=torch.Generator().manual_seed(4))
    got = frontend_fn(audio_length=t, melbins=f, mean=front["mean"], std=front["std"],
                      sample_rate=front["sample_rate"])(wav)
    want = ref_fbank.log_mel(wav, sample_rate=front["sample_rate"], melbins=f, audio_length=t,
                             mean=front["mean"], std=front["std"])
    assert got.shape == want.shape
    assert (got.double() - want).abs().max() < 1e-4


def test_fbank_pads_to_the_length():
    wav = torch.randn((1, 16000))
    out = ref_fbank.log_mel(wav, sample_rate=16000, melbins=8, audio_length=200, mean=1.0,
                            std=2.0)
    assert out.shape == (1, 200, 8)
    assert torch.all(out[0, 98:] == (0.0 - 1.0) / 4.0)


def test_train_steps_match_the_port():
    cell = harness.load_cell("tiny-fobi.train", TINY)
    session = train_driver.setup(cell, 21, CPU)
    out, _ = session.finish()
    got = train_driver.program_view(cell, 21, out, CPU)
    want = train_driver.reference(cell, 21, out, CPU)
    for g, w in zip(got["losses"], want["losses"]):
        assert g == pytest.approx(w, rel=1e-5)
    nums = train_driver.compare(got, want)
    assert nums["grad1_norm_gap"] < 1e-4 and nums["change_norm_gap"] < 1e-3


def test_half_batch_changes_the_step():
    cell = harness.load_cell("tiny-fobi.train", TINY)
    session = train_driver.setup(cell, 22, CPU)
    out, _ = session.finish()
    full = train_driver.reference(cell, 22, out, CPU)
    half = train_driver.reference(cell, 22, out, CPU, half_batch=True)
    assert train_driver.compare(half, full)["grad1_norm_gap"] > 0.05


def test_adam_update_is_torch_adam():
    p = torch.randn(50, generator=torch.Generator().manual_seed(5))
    q = p.clone().requires_grad_(True)
    opt = torch.optim.Adam([q], lr=1e-2, betas=(0.95, 0.999), eps=1e-8, weight_decay=0.1)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    for step in range(1, 4):
        g = torch.randn(50, generator=torch.Generator().manual_seed(10 + step))
        q.grad = g.clone()
        opt.step()
        ref_train.adam_update(p, g + 0.1 * p, m, v, step, 1e-2, (0.95, 0.999), 1e-8)
    assert torch.allclose(p, q.detach(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_matches_the_ports_oracle(reverse):
    from aum_tpu_torch.ops.scan_ref import selective_scan_ref

    g = torch.Generator().manual_seed(6)
    b, L, d, n = 2, 9, 5, 3
    u, delta, z = (torch.randn((b, L, d), generator=g) for _ in range(3))
    a = -torch.rand((d, n), generator=g) - 0.1
    bm, cm = torch.randn((b, L, n), generator=g), torch.randn((b, L, n), generator=g)
    dd, bias = torch.randn(d, generator=g), torch.randn(d, generator=g)
    got = selective_scan(u, delta, a, bm, cm, dd, z, bias, reverse=reverse)
    want = selective_scan_ref(u, delta, a, bm, cm, dd, z, bias, delta_softplus=True,
                              reverse=reverse)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("reverse", [False, True])
def test_recurrence_gradient(reverse):
    g = torch.Generator().manual_seed(7)
    a = torch.rand((6, 2, 3), generator=g, dtype=torch.float64).requires_grad_(True)
    b = torch.randn((6, 2, 3), generator=g, dtype=torch.float64).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda a, b: LinearRecurrence.apply(a, b, reverse), (a, b))


def test_fp8_rounding():
    x = torch.linspace(-3.0, 3.0, 101)
    r = precision.fp8_round(x)
    assert torch.all((r - x).abs() <= x.abs().max() * 2.0 ** -4 + 1e-12)
    assert not torch.equal(r, x)
    assert torch.equal(precision.fp8_round(r), r)
