"""Training steps for the organizations' local fits."""
