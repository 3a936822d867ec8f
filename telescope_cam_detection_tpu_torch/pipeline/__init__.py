"""Stage-2 pipeline: species classifier, two-stage pipeline, host re-rankers."""
