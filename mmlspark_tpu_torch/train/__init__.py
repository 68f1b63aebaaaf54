"""Training on one device: the train loop, its input pipeline and
on-device preprocessing."""
