"""KD training: state, train/eval steps, schedulers, checkpoints and the speech recipe."""
