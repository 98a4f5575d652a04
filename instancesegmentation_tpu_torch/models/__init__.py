"""The Segment network as ``nn.Module``s, BN folding, the folded head and
stems, and int8 post-training quantisation."""
