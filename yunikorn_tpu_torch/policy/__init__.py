"""The learned dispatch policy (solver.policy=learned and all), the JAX
package's policy/ in PyTorch: the serving half and the offline trainer.

A two-tower scorer, trained offline, scores asks against nodes inside the
assignment solve: an additive term in the odd rounds' best-node score and
gated proposal overrides (ops/learned). Its plan enters the core's duel
like any other arm, so a bad checkpoint is a measured no-op.

Modules:
  features   fixed-width feature rows over the solve's arguments ([N,
             F_POD] pod rows, [M, F_NODE] node rows), as tensors
  net        the two towers over parameters on a device, and the
             versioned checkpoint format (.npz + JSON manifest) with
             reject-on-mismatch validation, byte for byte the JAX
             package's
  train      the duel dataset format (DatasetWriter, the core's
             policy_recorder) and the two-phase fit on a device
             (cmd/policy_train is its command line)
"""
