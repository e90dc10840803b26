"""EPIC-SOUNDS SpecAugment: the sparse-image time warp and the mean-fill
masks, batched in PyTorch.

Counterpart of ``aum_tpu/audio/spec_warp.py``, which follows the reference's
``spec_augment.py``:

- ``interpolate_spline_flow``: polyharmonic-spline interpolation (order 2,
  phi(r^2) = 0.5 r^2 log r^2) of control-point flows, solved for the
  minimum-norm solution;
- ``dense_image_warp``: bilinear warp, output(y, x) = img(y - flow_y,
  x - flow_x), the query clamped to the image;
- ``time_warp``: the *value* of the spectrogram at a random time on the
  centre mel row is taken as the warp point's time coordinate and moved by a
  random shift in [-W, W) (the reference's quirk, kept: the coordinate is a
  log-mel value and may be negative);
- ``freq_mask`` / ``time_mask``: a mask of width w ~ [0, param), start ~
  [0, len - w), end ~ start + [0, w) (none where w = 0), filled with the
  clip's mean taken *after* the masks before it;
- ``combined_transforms``: time warp, two frequency masks, two time masks.

Layout (B, T, F), as in the JAX package; the reference's (F, T) view (rows
= mel bins) is a transpose. Each transform is split into a *draw* of its
random values from an explicit ``torch.Generator`` on the batch's device and
an *apply* that is a plain function of them, so a test can hand the JAX
functions' draws to the port.

On the card the whole batch is warped at once: one batched SVD solve of the
clips' spline systems and one gather of the four bilinear corners of every
clip's (F, T) grid. The solve is an SVD-based minimum-norm least squares
with JAX's ``lstsq`` cut-off (singular values below eps * max(rows, cols)
times the largest are dropped): with one control point the (4, 4) system
has rank 2, which ``torch.linalg.lstsq``'s one CUDA solver (``gels``, full rank
only) cannot take. It runs in float64: the one-point system's rbf weight is
0 in exact arithmetic, and whatever an fp32 solve leaves of it is multiplied
by phi(r^2), up to ~7e6 at the far corner of a (128, 1024) grid, so a 1e-9
residue would move the warp by ~7e-3 of a pixel (LAPACK's fp32 SVD, which
JAX uses on the CPU, returns exactly 0 there; the card's solver need not).
"""

from __future__ import annotations

import torch


def _phi2(r2: torch.Tensor) -> torch.Tensor:
    return 0.5 * r2 * torch.log(torch.clamp_min(r2, 1e-10))


def lstsq_min_norm(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """The minimum-norm least-squares solution of lhs (..., m, n) @ x = rhs
    (..., m, k), through the SVD with ``jnp.linalg.lstsq``'s default cut-off
    for the inputs' dtype; solved in float64, returned in that dtype."""
    u, s, vh = torch.linalg.svd(lhs.double(), full_matrices=False)
    rcond = torch.finfo(lhs.dtype).eps * max(lhs.shape[-2:])
    keep = s >= rcond * s[..., :1]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return (vh.mT @ (s_inv[..., None] * (u.mT @ rhs.double()))).to(lhs.dtype)


def interpolate_spline_flow(train_points: torch.Tensor, train_values: torch.Tensor,
                            query_points: torch.Tensor) -> torch.Tensor:
    """Polyharmonic spline (order 2) through the control points, batched.

    train_points, train_values: (B, n, 2) control points (y, x) and their
    flows; query_points: (m, 2) or (B, m, 2). Returns (B, m, 2) fp32.
    """
    c = train_points.float()
    f = train_values.float()
    bsz, n, _ = c.shape
    d2 = ((c[:, :, None, :] - c[:, None, :, :]) ** 2).sum(-1)
    mat_a = _phi2(d2)  # (B, n, n)
    mat_b = torch.cat([c, torch.ones((bsz, n, 1), device=c.device)], dim=2)  # (B, n, 3)
    lhs = torch.cat([torch.cat([mat_a, mat_b], dim=2),
                     torch.cat([mat_b.mT, torch.zeros((bsz, 3, 3), device=c.device)], dim=2)],
                    dim=1)
    rhs = torch.cat([f, torch.zeros((bsz, 3, 2), device=c.device)], dim=1)
    sol = lstsq_min_norm(lhs, rhs)
    w, v = sol[:, :n], sol[:, n:]
    q = query_points.float()
    if q.ndim == 2:
        q = q.expand(bsz, -1, -1)
    d2q = ((q[:, :, None, :] - c[:, None, :, :]) ** 2).sum(-1)  # (B, m, n)
    lin = torch.cat([q, torch.ones((*q.shape[:2], 1), device=q.device)], dim=2) @ v
    return _phi2(d2q) @ w + lin


def dense_image_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear warp of img (B, H, W) by flow (B, H, W, 2) in (y, x) order:
    output(y, x) = img(y - flow_y, x - flow_x), clamped to the image. The
    four corners of every pixel of every image come from one gather."""
    bsz, h, wd = img.shape
    gy = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    gx = torch.arange(wd, dtype=torch.float32, device=img.device)[None, :]
    qy = torch.clamp(gy - flow[..., 0], 0.0, h - 1.0)
    qx = torch.clamp(gx - flow[..., 1], 0.0, wd - 1.0)
    y0 = torch.clamp(torch.floor(qy).long(), 0, h - 2)
    x0 = torch.clamp(torch.floor(qx).long(), 0, wd - 2)
    wy = qy - y0
    wx = qx - x0
    base = y0 * wd + x0
    idx = torch.stack([base, base + 1, base + wd, base + wd + 1], dim=1)  # (B, 4, H, W)
    corners = torch.gather(img.reshape(bsz, h * wd), 1, idx.reshape(bsz, -1))
    tl, tr, bl, br = corners.reshape(bsz, 4, h, wd).unbind(1)
    top = tl + wx * (tr - tl)
    bot = bl + wx * (br - bl)
    return top + wy * (bot - top)


def sparse_image_warp(img: torch.Tensor, src_pts: torch.Tensor,
                      dst_pts: torch.Tensor) -> torch.Tensor:
    """img (B, H, W) warped so that the control points src_pts (B, n, 2) move
    to dst_pts (B, n, 2), (y, x) order."""
    bsz, h, wd = img.shape
    flows = dst_pts.float() - src_pts.float()
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=img.device),
                            torch.arange(wd, dtype=torch.float32, device=img.device),
                            indexing="ij")
    query = torch.stack([gy.reshape(-1), gx.reshape(-1)], dim=1)
    dense = interpolate_spline_flow(dst_pts, flows, query).reshape(bsz, h, wd, 2)
    return dense_image_warp(img, dense)


def draw_time_warp(generator: torch.Generator, shape: tuple, W: int) -> dict | None:
    """{'point': (B,) int64 time in [W, T - W), 'dist': (B,) int64 shift in
    [-W, W)} for a (B, T, F) batch; None when W <= 0 (no warp)."""
    if W <= 0:
        return None
    b, t, _ = shape
    device = generator.device
    return {"point": torch.randint(W, t - W, (b,), generator=generator, device=device),
            "dist": torch.randint(-W, W, (b,), generator=generator, device=device)}


def apply_time_warp(spec: torch.Tensor, draws: dict | None) -> torch.Tensor:
    if draws is None:
        return spec
    b, _, f = spec.shape
    y = torch.full((b,), float(f // 2), device=spec.device)
    # The warp point's time coordinate is the spectrogram's value there.
    p = spec[torch.arange(b, device=spec.device), draws["point"], f // 2].float()
    src = torch.stack([y, p], dim=1)[:, None]
    dst = torch.stack([y, p + draws["dist"].float()], dim=1)[:, None]
    return sparse_image_warp(spec.transpose(1, 2), src, dst).transpose(1, 2)


def time_warp(generator: torch.Generator, spec: torch.Tensor, W: int = 5) -> torch.Tensor:
    """Batched EPIC time warp of spec (B, T, F)."""
    return apply_time_warp(spec, draw_time_warp(generator, spec.shape, W))


def draw_mask(generator: torch.Generator, batch: int, length: int, param: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(start, end), each (batch,) int64: a mask [start, end) along an axis of
    ``length``, of width w ~ [0, param), start ~ [0, length - w) and end ~
    start + [0, w), or start + 0 where w = 0."""
    device = generator.device
    if param > 0:
        w = torch.randint(0, param, (batch,), generator=generator, device=device)
    else:
        w = torch.zeros((batch,), dtype=torch.int64, device=device)
    u = torch.rand((2, batch), generator=generator, device=device)
    start = torch.floor(u[0] * (length - w)).long()
    end = start + torch.where(w > 0, torch.floor(u[1] * w).long(), 0)
    return start, end


def apply_mean_mask(spec: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
                    axis: int) -> torch.Tensor:
    """Positions [start, end) of ``axis`` (1 = time, 2 = freq) set to each
    clip's mean over (T, F)."""
    length = spec.shape[axis]
    pos = torch.arange(length, device=spec.device)
    m = (pos[None] >= start[:, None]) & (pos[None] < end[:, None])
    shape = [spec.shape[0], 1, 1]
    shape[axis] = length
    mean = spec.mean(dim=(1, 2), keepdim=True)
    return torch.where(m.reshape(shape), mean, spec)


def draw_combined(generator: torch.Generator, shape: tuple, t_mask: int = 192,
                  f_mask: int = 48, t_warp: int = 5) -> dict:
    """The draws of ``combined_transforms`` on a (B, T, F) batch: 'warp'
    (``draw_time_warp``), then 'freq' and 'time', two (start, end) each."""
    b, t, f = shape
    return {"warp": draw_time_warp(generator, shape, t_warp),
            "freq": [draw_mask(generator, b, f, f_mask) for _ in range(2)],
            "time": [draw_mask(generator, b, t, t_mask) for _ in range(2)]}


def apply_combined(spec: torch.Tensor, draws: dict) -> torch.Tensor:
    """Time warp, then the frequency masks, then the time masks, in order."""
    spec = apply_time_warp(spec, draws["warp"])
    for start, end in draws["freq"]:
        spec = apply_mean_mask(spec, start, end, axis=2)
    for start, end in draws["time"]:
        spec = apply_mean_mask(spec, start, end, axis=1)
    return spec


def combined_transforms(generator: torch.Generator, spec: torch.Tensor, t_mask: int = 192,
                        f_mask: int = 48, t_warp: int = 5) -> torch.Tensor:
    """time_warp -> freq_mask x2 -> time_mask x2 of spec (B, T, F)."""
    return apply_combined(spec, draw_combined(generator, spec.shape, t_mask, f_mask, t_warp))
