"""Device milliseconds a step under SPFormer's QueryDecoder, forward and backward."""

from benchmark.lib import readers


def read(run):
    return readers.range_ms(run, "bench.decoder")
