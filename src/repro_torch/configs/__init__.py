"""The paper's experiment protocols."""
