"""Train step, checkpoints and the train / eval loop."""
