"""Traffic: the world generator, the frame renderer and one JSON file of
parameters per traffic mix, found by the name in BENCHMARK.json."""
