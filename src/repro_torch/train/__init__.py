"""Training of the port: data sources, AdamW, the train step and
``Trainer``, checkpoints, and the Super-Sub cascade's members."""
