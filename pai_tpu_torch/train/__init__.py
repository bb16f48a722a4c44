"""Training of the port: optimizer and train state, exponential moving
average, the Palette train and sample steps, and the ``Trainer`` loop."""
