"""The share of the frame slots the scorer's batches hold that are
padding: 100 x (1 - `score.frames` / `score.frame_slots`), the
program's counters (utils/timer.py; B x T_b slots a batch) over the
window."""


def read(ctx):
    counts = ctx["counts"]
    if ctx["kind"] != "score" or not counts.get("score.frame_slots"):
        return None
    return 100.0 * (1.0 - counts["score.frames"]
                    / counts["score.frame_slots"])
