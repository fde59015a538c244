"""Preemption shape limits shared with the snapshot encoder.

`NodeArrays` sizes its per-node victim tables by MAX_VICTIMS_PER_NODE, so the
port carries the constant with the value of the JAX package's ops/preempt.py.
The victim-table policy and the batched planner are ROADMAP item 8.
"""
MAX_VICTIMS_PER_NODE = 16
