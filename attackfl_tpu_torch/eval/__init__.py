"""Server-side validation."""
