"""Host-side helpers of the progressive render: checkpoints and profiling."""
