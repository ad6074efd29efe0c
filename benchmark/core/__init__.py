"""The harness's machinery: the registry of cells, the weights and inputs
made from the seed, the clocks, the trace reader, the chip's peaks, the
counts of operations and bytes, and the result line."""
