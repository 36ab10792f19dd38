"""model step: the model FLOPs of the real tokens the window processed
(prompt tokens of its dispatches and one token a live slot of its decode
steps, with attention over live keys; never padding) over the window and
the card's bf16 peak."""
from benchkit.readers import in_window, share_of_peak, step_flops


def read(run):
    return share_of_peak(run, step_flops(
        run, in_window(run, run.rec.dispatches),
        in_window(run, run.rec.steps)), run.seconds)
