"""ba.lm_iter_ms: time of bundle adjustment per LM iteration: the
benchmark's span around each frame_step.ba_round call (synchronised before
and after), summed, over the LM iterations they ran
(bundle.HOST_READS["bundle_adjust"] before and after), in the traced
run's stage-timer segment. Nothing where no round ran."""


def read(data):
    iters = sum(n for _, n in data["ba"])
    if iters == 0:
        return None
    return 1e3 * sum(s for s, _ in data["ba"]) / iters
