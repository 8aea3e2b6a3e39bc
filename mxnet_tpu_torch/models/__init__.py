"""Model geometry shared with the reference package's model zoo."""
