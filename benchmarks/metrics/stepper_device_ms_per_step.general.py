"""stepper_device_ms_per_step.general: ``stepper_device_ms_per_step`` in
the general path's cells, where it moves the card's time per frame, not
the rate."""

from benchmarks.harness.cells import metric_reader

read = metric_reader("stepper_device_ms_per_step")
