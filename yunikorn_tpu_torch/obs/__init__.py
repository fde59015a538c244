"""Observability: metrics registry, cycle tracer, pod journeys, flight
recorder and SLO engine — the JAX package's obs/ modules the core builds,
copied with their imports rewritten.

  metrics.py    — declared counters / gauges / fixed-bucket histograms with
                  labels; Prometheus text exposition
  trace.py      — ring-buffered cycle/stage spans + Chrome trace-event export
  journey.py    — per-pod hop timeline (admitted → gated → solved →
                  committed → bound)
  flightrec.py  — post-mortem bundles on SLO violation / breaker exhaustion
  slo.py        — the scheduler's service-level objectives
"""
