"""Fault tolerance: restartable training, straggler detection, failure
drills."""
