"""Pipeline orchestration, statistics, distances and CSV output."""
