"""The Segment network as ``nn.Module``s, BN folding and the folded head."""
