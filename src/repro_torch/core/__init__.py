"""Framework-neutral core of the port: strategy trees, classifier,
absorption fit, quality policy, controller and campaign store."""
