"""odometry subpackage."""
