"""The harness's own modules: generator, yardstick, trace reduction, checks."""
