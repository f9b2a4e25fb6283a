"""The comparison that decides `correct`: the program's tables of each
sampled clip against the plain reference's tables of the same input.

Each number is held to the limit of its name in the configuration's
"limits" (see PERF.md for the readings each limit was set from):

  missing        sampled clips whose tables lack a key the reference has, or
                 have another shape or dtype
  hue_off        hue_table entries that differ (uint8, exact)
  rgb_hue_off    rgb_hue_table entries that differ (the hue of integer means)
  centroid_off   centroid cells (4 int32 channels) that differ in any channel
  flow_bgr_off   bytes of the rendered flow that differ (where it is returned)
  magnitude_gap  the widest gap of a pair's mean |flow|, as a share of the
                 clip's largest mean |flow| in the reference
"""

from __future__ import annotations

import numpy as np

NUMBERS = ("missing", "hue_off", "rgb_hue_off", "centroid_off", "flow_bgr_off", "magnitude_gap")


def compare(pairs: list[tuple[dict, dict]]) -> dict[str, float]:
    """Numbers over (program tables, reference tables) of every sampled clip."""
    n = dict.fromkeys(NUMBERS, 0)
    n["magnitude_gap"] = 0.0
    has_render = False
    for got, want in pairs:
        if any(k not in got or got[k].shape != v.shape or got[k].dtype != v.dtype for k, v in want.items()):
            n["missing"] += 1
            continue
        n["hue_off"] += int(np.count_nonzero(got["hue_table"] != want["hue_table"]))
        n["rgb_hue_off"] += int(np.count_nonzero(got["rgb_hue_table"] != want["rgb_hue_table"]))
        n["centroid_off"] += int(np.count_nonzero((got["centroids"] != want["centroids"]).any(axis=-1)))
        if "flow_bgr" in want:
            has_render = True
            n["flow_bgr_off"] += int(np.count_nonzero(got["flow_bgr"] != want["flow_bgr"]))
        ref = want["mean_magnitude"].astype(np.float64)
        gap = np.abs(got["mean_magnitude"].astype(np.float64) - ref)
        n["magnitude_gap"] = max(n["magnitude_gap"], float(gap.max() / max(float(np.abs(ref).max()), 1e-12)))
    if not has_render:
        del n["flow_bgr_off"]
    return n


def checks(numbers: dict[str, float], limits: dict[str, float]) -> dict[str, dict[str, float]]:
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}


def passed(checked: dict[str, dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checked.values())
