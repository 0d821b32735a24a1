"""schedule_ms.train: milliseconds of the trainer's batch order
(``schedule.order``) per epoch of the training window; moves
train_nodes_per_s.
"""
from perfbench.harness import spans


def read(ctx):
    return spans.schedule_ms(spans.snapshot())
