"""The port's tools: the proofs, the dataset check and the 1-NN variant
probe."""
