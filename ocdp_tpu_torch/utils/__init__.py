"""Quaternion, frame and ODE-integration utilities of the rollouts."""
