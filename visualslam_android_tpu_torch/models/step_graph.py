"""The tracking step run from static buffers: on the CUDA card captured
CUDA graphs of ``frame_step``, one replayed a frame; on the CPU the same
step run eagerly into the same kind of reused buffers.

Run eagerly, the step is ~10k small launches a frame, and the host's cost
of issuing them is many times the card's cost of running them. The step's
shapes are fixed by the configuration, its loops have fixed trip counts,
it reads nothing back to the host and its two random draws are made
outside it, so it is captured once and replayed. Its only host-side
choices are the flags (use_prior, forced_coarse), which take the three
values of ``VARIANTS``.

Buffers. Every input tensor of the step has a static buffer. The state the
step hands back (the map's points and measurements, the pose, motion model,
scene depth, SBI and new-point queue) has two, sets 0 and 1: a step reads
the set the last step wrote (set 0 first) and writes its new state into the
other, which it returns, so the caller that keeps its state hands back the
set the next step reads. Every other input has one buffer, and the keyframe
store is adopted as it is: the step only reads it, and the mapping tasks
write it in place (keyframe.insert_keyframe). The first step makes the
buffers as copies of its inputs. Before each step an input tensor is copied
into its buffer where it is not that buffer (compared by data_ptr, no device
read): the state a mapping task or the relocalizer replaced, and the inputs
that are not state (the image, camera, scene-depth wiggle, failure mask and
pending pair: a few small copies and the image's), and nothing else.

The other outputs (the frame, found / found_pos / search_level /
did_subpix, stats) are overwritten by the next step, in the graphs' memory
pool on the card and in reused buffers on the CPU: a caller keeps its own
copy of whatever it keeps across a step.

Capture. On the first step on the card each variant runs once eagerly on a
side stream (filling utils.tensors.const's and the level-offset caches and
letting cuBLAS and cuSOLVER set up their workspaces), then each variant is
captured reading each state set: six graphs in one shared memory pool.
Sharing is safe here: each replay recomputes every output from the static
buffers, which lie outside the pool, and no output outlives the next step,
so one graph's scratch may overlap another graph's outputs. ``counts``
counts captures, replays and eager steps (every step on the CPU, the
warm-ups on the card). The kernels' wrappers count their calls as ever: a
warm-up's and a capture's (which records the launch into its graph); a
replay runs the recorded kernels with no wrapper call.
"""

from __future__ import annotations

import dataclasses
import gc

import torch

from visualslam_android_tpu_torch.utils.tensors import tree_leaves, tree_map

# (use_prior, forced_coarse): a tracked frame, the frame after a
# relocalization, a relocalized frame.
VARIANTS = ((True, False), (True, True), (False, True))

# The step's tensor inputs in frame_step's order, then the two draws.
INPUTS = ("img", "slam_map", "cam", "R", "t", "velocity", "msd",
          "depth_mean", "wiggle_depth_norm", "sbi_last", "new_points",
          "failure_mask", "pending", "uniforms")

# FrameStepOut's state fields and the inputs they feed next frame.
STATE = (("slam_map", "slam_map"), ("R", "R"), ("t", "t"),
         ("velocity", "velocity"), ("msd", "msd"), ("depth", "depth_mean"),
         ("sbi", "sbi_last"), ("new_points", "new_points"))

# FrameStepOut's other fields: valid until the next step.
OUTPUTS = ("frame", "found", "found_pos", "search_level", "did_subpix",
           "stats")


def _labelled(label, value):
    """[(label, tensor)] of a tensor, tuple or TensorTree, in field order
    (tree_leaves' order)."""
    if isinstance(value, torch.Tensor):
        return [(label, value)]
    if isinstance(value, tuple):
        return [pair for i, v in enumerate(value)
                for pair in _labelled(f"{label}[{i}]", v)]
    if not dataclasses.is_dataclass(value):
        return []
    return [pair for f in dataclasses.fields(value)
            for pair in _labelled(f"{label}.{f.name}", getattr(value, f.name))]


def _input_leaves(inputs):
    return [x for name in INPUTS for x in tree_leaves(inputs[name])]


def _input_labels(inputs):
    return [label for name in INPUTS
            for label, _ in _labelled(name, inputs[name])]


class StepGraphs:
    """The step cache of one SLAMSystem: pass it to frame_step as
    `graphs=`. It serves one configuration, with the shapes of the first
    step's inputs."""

    def __init__(self):
        self.counts = {"captures": 0, "replays": 0, "eager": 0}
        self._config = None
        self._state = None      # per tensor: True where it is state
        self._flat = None       # per state set: the buffers, INPUTS order
        self._bufs = None       # per state set: input name -> buffer tree
        self._ptrs = None       # data_ptr of every buffer
        self._next = 0          # the set the next step reads (the last
        #                         step wrote it)
        self._graphs = {}       # (flags, set) -> (graph, output)
        self._out = None        # CPU: reused buffers of OUTPUTS

    def step(self, body, img, slam_map, cam, R, t, velocity, msd, depth_mean,
             wiggle_depth_norm, sbi_last, new_points, failure_mask, pending,
             config, use_prior=True, forced_coarse=False, uniforms=None,
             generator=None):
        """frame_step's result for these inputs, through `body` (the plain
        step): a graph replay on the card, an eager run on the CPU. Without
        `uniforms` the two draws come from `generator` as track_map makes
        them, into their buffers."""
        flags = (bool(use_prior), bool(forced_coarse))
        if flags not in VARIANTS:
            raise ValueError(f"no step variant for (use_prior, "
                             f"forced_coarse) = {flags}")
        if uniforms is None:
            uniforms = self._draw(slam_map.points.n_slots, R, generator)
        inputs = dict(zip(INPUTS, (
            img, slam_map, cam, R, t, velocity, msd, depth_mean,
            wiggle_depth_norm, sbi_last, new_points, failure_mask, pending,
            tuple(uniforms))))
        if self._bufs is None:
            self._adopt(inputs, config)
        elif config is not self._config:
            raise ValueError("a StepGraphs serves the configuration of its "
                             "first step")
        self._load(inputs)
        if self._flat[0][0].device.type == "cuda":
            return self._replay(body, flags)
        self.counts["eager"] += 1
        return self._reuse(self._run(body, flags, self._next, write=True))

    # ---- buffers -----------------------------------------------------

    def _draw(self, n, R, generator):
        """track_map's two draws, `torch.rand(n)` twice from `generator`:
        into their buffers once those exist (the same bits)."""
        if self._bufs is None:
            return tuple(torch.rand(n, generator=generator, dtype=R.dtype,
                                    device=R.device) for _ in range(2))
        out = self._bufs[0]["uniforms"]
        for u in out:
            torch.rand(n, generator=generator, out=u)
        return out

    def _adopt(self, inputs, config):
        """Both sets of buffers, shaped as the first step's inputs (which
        _load then copies in), and the keyframe store itself."""
        self._config = config
        state_names = {name for _, name in STATE}
        labelled = _input_labels(inputs)
        kept = [label.startswith("slam_map.keyframes.") for label in labelled]
        self._state = [label.split(".")[0] in state_names and not k
                       for label, k in zip(labelled, kept)]
        flat0 = [x if k else torch.empty_like(x)
                 for x, k in zip(_input_leaves(inputs), kept)]
        flat1 = [torch.empty_like(b) if state else b
                 for b, state in zip(flat0, self._state)]
        self._flat = (flat0, flat1)
        self._bufs = tuple(self._tree(flat, inputs) for flat in self._flat)
        self._ptrs = {b.data_ptr() for flat in self._flat for b in flat}

    @staticmethod
    def _tree(flat, like):
        """The inputs' structure (`like`) over the tensors `flat`."""
        it = iter(flat)
        return {name: tree_map(lambda _: next(it), like[name])
                for name in INPUTS}

    def _load(self, inputs):
        """Copy each input tensor into its buffer (a state tensor into the
        set the step reads) where it is not that buffer."""
        leaves = _input_leaves(inputs)
        if len(leaves) != len(self._state):
            raise ValueError("the step's inputs changed structure")
        for i, (x, buf) in enumerate(zip(leaves, self._flat[self._next])):
            if x.data_ptr() == buf.data_ptr():
                continue
            if x.shape != buf.shape or x.dtype != buf.dtype:
                raise ValueError(f"{_input_labels(inputs)[i]}: {x.dtype} "
                                 f"{tuple(x.shape)} where the step took "
                                 f"{buf.dtype} {tuple(buf.shape)}")
            buf.copy_(x)

    # ---- the step ----------------------------------------------------

    def _run(self, body, flags, src, write):
        """The plain step on state set `src`; with `write`, its new state
        copied into the other set and returned as that set's buffers."""
        b = self._bufs[src]
        out = body(*(b[name] for name in INPUTS[:-1]), self._config,
                   use_prior=flags[0], forced_coarse=flags[1],
                   uniforms=b["uniforms"])
        if not write:
            return out
        dst = self._bufs[1 - src]
        for out_name, in_name in STATE:
            for new, old, buf in zip(tree_leaves(getattr(out, out_name)),
                                     tree_leaves(b[in_name]),
                                     tree_leaves(dst[in_name])):
                if new.data_ptr() == buf.data_ptr():
                    continue
                if buf.data_ptr() == old.data_ptr() or (
                        new.data_ptr() != old.data_ptr()
                        and new.data_ptr() in self._ptrs):
                    raise RuntimeError(f"the step's {out_name} output "
                                       "writes a buffer it reads")
                buf.copy_(new)
        self._next = 1 - src
        return out.replace(**{o: dst[i] for o, i in STATE})

    def _reuse(self, out):
        """`out` with OUTPUTS in reused buffers (CPU): each step overwrites
        them, as each replay overwrites a graph's. A tensor that is an
        input buffer (level 0 of the pyramid is the image's) stays so."""
        if self._out is None:
            self._out = {name: tree_map(
                lambda x: x if x.data_ptr() in self._ptrs
                else torch.empty_like(x), getattr(out, name))
                for name in OUTPUTS}
        for name in OUTPUTS:
            for new, buf in zip(tree_leaves(getattr(out, name)),
                                tree_leaves(self._out[name])):
                if new.data_ptr() != buf.data_ptr():
                    buf.copy_(new)
        return out.replace(**self._out)

    def _replay(self, body, flags):
        if not self._graphs:
            self._capture(body)
        graph, out = self._graphs[flags, self._next]
        graph.replay()
        self._next = 1 - self._next
        self.counts["replays"] += 1
        return out

    def _capture(self, body):
        """One eager warm-up per variant on a side stream, then each
        variant captured on each state set, into one pool."""
        device = self._flat[0][0].device
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for flags in VARIANTS:
                self._run(body, flags, 0, write=False)
                self.counts["eager"] += 1
        current.wait_stream(side)
        # A CUDA graph that the cyclic collector frees during a capture
        # (another facade's, dropped in a reference cycle) is destroyed by a
        # call that invalidates the capture: collect first, and not during.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        next_ = self._next
        try:
            pool = None
            for src in (0, 1):
                for flags in VARIANTS:
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph, pool=pool):
                        out = self._run(body, flags, src, write=True)
                    pool = graph.pool()
                    self._graphs[flags, src] = (graph, out)
                    self.counts["captures"] += 1
        finally:
            self._next = next_
            if collecting:
                gc.enable()
