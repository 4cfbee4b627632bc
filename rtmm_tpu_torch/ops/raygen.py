"""Primary-ray generation (port of shaders/raygen.hlsl:12-44).

Per pixel: uv = (idx + 0.5)/size -> NDC in [-1,1] with Y flipped (DX
convention) -> unproject z=0 and z=1 with inverse(view-projection) ->
normalized direction. The only per-frame input is the 4x4 matrix (the
reference's single CBV upload, src/application.cpp:204-205).
"""
from __future__ import annotations

import torch

from . import _f32


def generate_rays(inv_view_proj, width: int, height: int,
                  render_width: int | None = None,
                  render_height: int | None = None, device="cuda",
                  rows: tuple[int, int] | None = None):
    """Returns (origins (H*W, 3), directions (H*W, 3)) in row-major pixel
    order, on `device`.

    render_width/height generate a larger (padded) pixel grid while keeping
    the NDC mapping of the logical width/height — padding pixels fall
    outside NDC [-1, 1] and are cropped by the caller. rows = (first, count)
    generates only those pixel rows of the grid (the same values as the
    whole grid's rows).
    """
    rw = render_width or width
    rh = render_height or height
    row0, n_rows = (0, rh) if rows is None else rows
    m = torch.as_tensor(inv_view_proj, dtype=torch.float32, device=device)
    px = torch.arange(rw, dtype=torch.float32,
                      device=device).expand(n_rows, rw)
    py = torch.arange(row0, row0 + n_rows, dtype=torch.float32,
                      device=device)[:, None].expand(n_rows, rw)
    u = _f32.div(px + 0.5, float(width))
    v = _f32.div(py + 0.5, float(height))
    ndc_x = u * 2.0 - 1.0
    ndc_y = -(v * 2.0 - 1.0)                      # raygen.hlsl:23

    def unproject(z):
        # Explicit per-component unproject (not a matmul): the w component
        # is a cancellation of ~5-magnitude terms that must stay float32
        # with one rounding per operation.
        p = [m[i, 0] * ndc_x + m[i, 1] * ndc_y + (m[i, 2] * z + m[i, 3])
             for i in range(4)]
        w = p[3]
        return torch.stack([p[0] / w, p[1] / w, p[2] / w], dim=-1)

    near = unproject(0.0)                          # raygen.hlsl:26
    far = unproject(1.0)                           # raygen.hlsl:27
    d = far - near
    # Left-to-right component sums, as the trace kernel's in-kernel raygen
    # (a .sum(-1) reduction may add in another order on the card).
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    d = d / torch.sqrt(dx * dx + dy * dy + dz * dz)[..., None]
    return near.reshape(-1, 3), d.reshape(-1, 3)
