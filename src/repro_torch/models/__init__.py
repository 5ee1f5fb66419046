"""Dense GQA language model: layers, caches, attention, blocks, the LM."""
