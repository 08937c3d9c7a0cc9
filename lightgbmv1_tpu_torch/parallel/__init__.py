"""Learners (the serial learner of the training slice)."""
