"""The mapping scheduler: which one unit of mapping work runs after a
tracked frame.

Port of the scheduler half of the JAX package's ``native_runtime.py``: the
task ids of native/vstpu_runtime.cpp's MapTask enum and its Python mirror
``scheduler_next_py``, both encoding the priority ladder of the reference's
MapMaker::run (jni/MapMaker.cc:80-123). HandleBadPoints is not a task: it
runs inside every tracking step. The ctypes bindings of the C++ runtime
(scheduler, image reader, map blobs) are not ported.
"""

from __future__ import annotations

TASK_NONE = 0
TASK_BA_RECENT = 1
TASK_REFIND_NEWLY = 2
TASK_BA_ALL = 3
TASK_REFIND_FAILURES = 4
TASK_ADD_KEYFRAME = 6

TASK_NAMES = {
    TASK_NONE: "none", TASK_BA_RECENT: "ba_recent",
    TASK_REFIND_NEWLY: "refind_newly", TASK_BA_ALL: "ba_all",
    TASK_REFIND_FAILURES: "refind_failures",
    TASK_ADD_KEYFRAME: "add_keyframe",
}


def scheduler_next_py(queue_size: int, recent_converged: bool,
                      full_converged: bool, has_failure_queue: bool,
                      has_newly_made: bool, rand20: bool) -> int:
    """The next task. Every bundle-adjustment and re-find rung needs an
    empty keyframe queue (MapMaker.cc:97, 102, 107, 112), so a queued
    keyframe goes first (:120-121); the failure-queue rung is reached only
    when both bundle adjustments have converged, one pass in 20 (:112)."""
    if queue_size > 0:
        return TASK_ADD_KEYFRAME
    if not recent_converged:
        return TASK_BA_RECENT
    if has_newly_made:
        return TASK_REFIND_NEWLY
    if not full_converged:
        return TASK_BA_ALL
    if rand20 and has_failure_queue:
        return TASK_REFIND_FAILURES
    return TASK_NONE
