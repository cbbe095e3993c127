"""pcg_iters_per_step.general: ``pcg_iters_per_step`` in the general
path's cells, where it moves the card's time per frame, not the rate."""

from benchmarks.harness.cells import metric_reader

read = metric_reader("pcg_iters_per_step")
