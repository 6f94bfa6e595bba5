"""The U-Net segmenter: the network, its weight folding and the predictor."""
