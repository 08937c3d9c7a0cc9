"""Learners: the serial learner and the data, voting and feature
learners over a ``torch.distributed`` group (trainer.py), their
collectives (collectives.py), the cluster bring-up (cluster.py) and the
distributed loader (dist_data.py)."""
