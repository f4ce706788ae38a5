"""Per-layer metric readers: one module per metric of BENCHMARK.json's
`per_layer`, named as the metric, each with `read(ctx) -> float | None`
(None: nothing to read in this run, and the metric is left out of the
line). `ctx` holds the window's utils.perf phases (`phases`, `samples`),
the port's launch counters over the window (`launches`), the
configuration's window shapes (`dims`), the traced slice's summary
(`trace`, benchmark/trace.summarize) and the window's frame count."""
