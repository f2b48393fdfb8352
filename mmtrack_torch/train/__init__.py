"""ViPT prompt-tuning training of the port: objective, optimizer, step, trainer
and the `python -m mmtrack_torch.train.run` entry point."""
