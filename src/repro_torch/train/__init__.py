"""Training options (the step builders come with the protected-LM slice)."""
