"""Training: AdamW, the LM loss and step, and npz checkpoints that the
reference package reads too."""
