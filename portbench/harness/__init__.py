"""What every cell shares: the manifest, inputs and weights from the seed,
clocks, the profile's reduction, the comparisons and the result line."""
