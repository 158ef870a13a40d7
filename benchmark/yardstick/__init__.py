"""What the benchmark measures with: operation and byte counts from layer
shapes, the table of peaks, and the reading of a device trace."""
