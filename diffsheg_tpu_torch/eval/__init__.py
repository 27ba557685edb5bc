"""Evaluation: the FGD feature net and FGD, the pose metrics, SRGR, beat
alignment."""
