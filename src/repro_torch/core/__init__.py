"""GAL core at LM scale: losses, assistance weights, planner, fit."""
