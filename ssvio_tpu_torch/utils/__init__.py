"""Host utilities of the port: checkpointing and profiling."""
