"""Models of the port: DINO ViT, featurizer, probes."""
