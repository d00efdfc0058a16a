"""nn.Modules of the CLIP towers, the SegViT grouping backbone, the MAE
decoders and the SegCLIP losses."""
