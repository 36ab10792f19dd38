"""engine: the mean host wall of a decode iteration (page growth and the
step, to the tokens read back), over the window."""
from benchkit.readers import in_window, wall_ms


def read(run):
    return wall_ms(in_window(run, run.rec.steps))
