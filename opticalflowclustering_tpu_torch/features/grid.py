"""Grid-cell pooling (port of `opticalflowclustering_tpu/features/grid.py`).

The reference slices every frame into rows×cols cells and draws a white
1-px rectangle around each cell as it goes; since the cells are views into
the frame, those white lines leak into every mean it computes, so they are
part of the output contract:
- OutCSV path: every cell has a white top row and left column
  (own_rectangle=True);
- `*_rgb_values.csv` path: white top row only for grid-row>0, white left
  column only for grid-col>0 (own_rectangle=False).
All integer arithmetic, bitwise equal to the reference.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from opticalflowclustering_tpu_torch.ops.colorspace import bgr2hsv


@dataclasses.dataclass(frozen=True)
class GridParams:
    """Grid geometry (`KmeanGrids.py:177`: 14×25). Steps are floor(W/cols),
    floor(H/rows); the right/bottom remainder is not covered by any cell."""

    rows: int = 14
    cols: int = 25

    def steps(self, height: int, width: int) -> tuple[int, int]:
        return height // self.rows, width // self.cols


def extract_cells(frames: torch.Tensor, grid: GridParams) -> torch.Tensor:
    """[..., H, W, C] → [..., rows*cols, ys, xs, C]: the reference's ROIs
    `frame[y1:y2, x1:x2]` (`KmeanGrids.py:85`) in its row-major order."""
    h, w, c = frames.shape[-3], frames.shape[-2], frames.shape[-1]
    ys, xs = grid.steps(h, w)
    lead = tuple(frames.shape[:-3])
    x = frames[..., : grid.rows * ys, : grid.cols * xs, :]
    x = x.reshape(lead + (grid.rows, ys, grid.cols, xs, c)).movedim(-3, -4)
    return x.reshape(lead + (grid.rows * grid.cols, ys, xs, c))


def whiten_grid_lines(cells: torch.Tensor, grid: GridParams, own_rectangle: bool) -> torch.Tensor:
    """The white 1-px grid lines drawn onto a cell tensor [..., cells, ys,
    xs, C] (a new tensor): own_rectangle=True gives every cell a white top
    row and left column (the OutCSV cells); False only the edges its
    earlier-scanned neighbours drew (top row for grid-row>0, left column for
    grid-col>0)."""
    cells = cells.clone()
    n = grid.rows * grid.cols
    if own_rectangle:
        top = left = torch.ones(n, dtype=torch.bool, device=cells.device)
    else:
        idx = torch.arange(n, device=cells.device)
        top, left = idx // grid.cols > 0, idx % grid.cols > 0
    cells[..., top, 0, :, :] = 255
    cells[..., left, :, 0, :] = 255
    return cells


def whiten_frame_lines(
    frames: torch.Tensor, grid: GridParams, own_rectangle: bool
) -> torch.Tensor:
    """The white 1-px grid lines drawn onto [..., H, W, C] frames."""
    h, w = frames.shape[-3], frames.shape[-2]
    ys, xs = grid.steps(h, w)
    y = torch.arange(h, device=frames.device)[:, None]
    x = torch.arange(w, device=frames.device)[None, :]
    in_grid = (y < grid.rows * ys) & (x < grid.cols * xs)
    if own_rectangle:
        line = (y % ys == 0) | (x % xs == 0)
    else:
        line = ((y % ys == 0) & (y >= ys)) | ((x % xs == 0) & (x >= xs))
    return torch.where((in_grid & line)[..., None], _white(frames.device, frames.dtype), frames)


@functools.lru_cache(maxsize=None)
def _white(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """255 as a 0-dim tensor on `device`, made once: a value made on the
    host per call is an upload (or a fill kernel) in every chunk."""
    with torch.inference_mode(False):
        return torch.tensor(255, dtype=dtype, device=device)


def grid_cell_sums(frames: torch.Tensor, grid: GridParams) -> torch.Tensor:
    """Per-cell int32 channel sums of [..., H, W, C] → [..., rows*cols, C]."""
    h, w, c = frames.shape[-3], frames.shape[-2], frames.shape[-1]
    ys, xs = grid.steps(h, w)
    lead = tuple(frames.shape[:-3])
    x = frames[..., : grid.rows * ys, : grid.cols * xs, :].to(torch.int32)
    x = x.reshape(lead + (grid.rows, ys, grid.cols * xs, c)).sum(dim=-3, dtype=torch.int32)
    x = x.reshape(lead + (grid.rows, grid.cols, xs, c)).sum(dim=-2, dtype=torch.int32)
    return x.reshape(lead + (grid.rows * grid.cols, c))


def grid_mean_bgr(frames: torch.Tensor, grid: GridParams) -> torch.Tensor:
    """Per-cell mean BGR truncated to uint8 (floor of sum/count, exact),
    with the rgb_values line semantics. [..., H, W, 3] → [..., cells, 3]."""
    h, w = frames.shape[-3], frames.shape[-2]
    ys, xs = grid.steps(h, w)
    s = grid_cell_sums(whiten_frame_lines(frames, grid, own_rectangle=False), grid)
    return (s // (ys * xs)).to(torch.uint8)


def grid_mean_hue(frames: torch.Tensor, grid: GridParams) -> torch.Tensor:
    """Per-cell mean-BGR hue, the `*_rgb_values.csv` feature:
    [..., H, W, 3] uint8 → [..., rows*cols] float32."""
    hsv = bgr2hsv(grid_mean_bgr(frames, grid))
    return hsv[..., 0].to(torch.float32)
