"""Adversarial training: the train step, schedules, the image pool, meters."""
