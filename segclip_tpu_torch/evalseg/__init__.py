"""Zero-shot semantic segmentation: text bank and sliding-window inference."""
