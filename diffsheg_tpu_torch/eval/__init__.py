"""Evaluation: the pose metrics of training's evaluation."""
