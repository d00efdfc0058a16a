"""nn.Modules of the CLIP towers and the SegViT grouping backbone."""
