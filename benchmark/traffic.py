"""The traffic of a cell: which frame the camera hands in at each call.

One general generator reads a workload's parameters (``workloads/<name>
.json``): the path (``reference/scene.path_pose``), how it is played
(``once``, or ``pingpong``: forward, then backward, again and again), the
pauses (after every ``moving`` calls the path waits for ``paused`` calls,
the camera held still, or with ``covered`` the lens covered: a uniform
grey of ``value``), the touches that start the bootstrap and the number of
set-up frames. Every
distinct frame is rendered once on the device, before the window, from the
run's seed; the seed changes the scene's texture, never the path, the
pauses or the number of frames.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from benchmark.reference import geometry, scene


@dataclasses.dataclass
class Traffic:
    frames: List[torch.Tensor]   # distinct frames [H, W] f32 on the device
    order: np.ndarray            # call n -> index into frames
    blank: np.ndarray            # call n -> the lens is covered
    truth_R: np.ndarray          # call n -> camera-from-world R (float64)
    truth_t: np.ndarray          # call n -> t
    touches: frozenset
    setup_frames: int

    def __len__(self):
        return len(self.order)

    def frame(self, n: int) -> torch.Tensor:
        return self.frames[self.order[n]]


def path_index(path: dict, p: int) -> int:
    """The path frame shown at the p-th visible call, or -1 past the end of
    a path played once."""
    unique = path["frames"]
    if path["playback"] == "once":
        return p if p < unique else -1
    if path["playback"] == "pingpong":
        period = 2 * (unique - 1)
        q = p % period
        return q if q < unique else period - q
    raise ValueError(f"unknown playback {path['playback']!r}")


def schedule(workload: dict):
    """(path frame per call, covered per call) for the workload's calls,
    as int and bool numpy arrays; a path played once ends the calls."""
    path, pause = workload["path"], workload.get("pause")
    idx, covered = [], []
    p = 0
    for n in range(workload["calls"]):
        if pause and n % (pause["moving"] + pause["paused"]) >= pause["moving"]:
            # The path waits at its last frame.
            idx.append(path_index(path, max(p - 1, 0)))
            covered.append(bool(pause["covered"]))
            continue
        k = path_index(path, p)
        if k < 0:
            break
        idx.append(k)
        covered.append(False)
        p += 1
    return np.asarray(idx, np.int64), np.asarray(covered, bool)


def make_traffic(config: dict, workload: dict, seed: int, device) -> Traffic:
    """Render the workload's frames on `device` from `seed`."""
    tc = config["slam_config"]["tracker"]
    height, width = tc["height"], tc["width"]
    cam = geometry.Camera.from_params(
        [config["slam_config"]["camera"][k] for k in
         ("fx", "fy", "cx", "cy", "w")], width, height)
    idx, covered = schedule(workload)
    R, t = scene.path_poses(workload["path"], int(idx.max()) + 1)
    tex = scene.make_texture(config["scene"], seed, device)
    rendered = scene.render(
        tex, config["scene"], cam,
        torch.from_numpy(R).to(device, torch.float32),
        torch.from_numpy(t).to(device, torch.float32), height, width)
    frames = [f.contiguous() for f in rendered]
    del tex, rendered
    order = idx.copy()
    if covered.any():
        frames.append(torch.full((height, width),
                                 float(workload["pause"]["value"]),
                                 device=device))
        order[covered] = len(frames) - 1
    return Traffic(frames=frames, order=order, blank=covered,
                   truth_R=R[idx], truth_t=t[idx],
                   touches=frozenset(workload["touches"]),
                   setup_frames=workload["setup_frames"])
