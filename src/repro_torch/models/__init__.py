"""The paper's models as layer IR."""
