"""The port's entry points the traffic mixes drive, one module each, and
what they share."""
